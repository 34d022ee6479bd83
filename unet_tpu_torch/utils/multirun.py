"""List-broadcast helpers for the multi-run entry point.

The port's copy of ``unet_tpu/utils/multirun.py`` (the reference's
utils.py:170-193 ``check_and_fill``, used by the multi entry point
create_tiles_train_predict_multi.py:113-204): length-1 lists are repeated
to the target length, mismatched lengths raise.
"""

from __future__ import annotations

from typing import List


def check_and_fill(args: List[list], target_len: int) -> List[list]:
    for i, arg in enumerate(args):
        if len(arg) == 1:
            args[i] = arg * target_len
        elif len(arg) != target_len:
            raise ValueError(
                f"Argument list at index {i} has {len(arg)} elements; expected {target_len}."
            )
    return args


def broadcast(values, target_len: int) -> list:
    """Scalar or length-1 list → repeated list; list of target_len → as-is."""
    if not isinstance(values, (list, tuple)):
        return [values] * target_len
    return check_and_fill([list(values)], target_len)[0]
