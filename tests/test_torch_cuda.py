"""PyTorch port on the card: the CUDA kernels against their plain versions.

Imports neither JAX nor ``unet_tpu``, so it also runs on a machine that has
only PyTorch with CUDA (and nvcc):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a CUDA device every test here skips.
"""

import numpy as np
import pytest
import torch

from unet_tpu_torch.ops import blend

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(seed, n, h, w, c, th, tw, dev):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([[0, h - th], rng.integers(0, h - th + 1, n - 2)])
    cols = np.concatenate([[w - tw, 0], rng.integers(0, w - tw + 1, n - 2)])
    g = torch.Generator(device=dev).manual_seed(seed)
    tiles = torch.randn((n, c, th, tw), generator=g, device=dev)
    mosaic = torch.randn((c, h, w), generator=g, device=dev)
    return tiles, rows, cols, mosaic, torch.zeros((h, w), device=dev)


@pytest.mark.parametrize("n,c", [(16, 3), (40, 2), (2, 1), (70, 4)])
def test_blend_count_bit_equal_to_plain(dev, n, c):
    """Up to and past 32 tiles (the kernel's mask width)."""
    tiles, rows, cols, m, cnt = _case(n, n, 300, 260, c, 64, 48, dev)
    mk, ck = m.clone(), cnt.clone()
    before = blend.blend_and_count.launches
    blend.blend_and_count(mk, ck, tiles, rows, cols)
    blend.blend_and_count_reference(m, cnt, tiles, rows, cols)
    torch.cuda.synchronize()
    assert blend.blend_and_count.launches == before + 1
    assert torch.equal(mk, m) and torch.equal(ck, cnt)


def test_blend_count_rejects_bad_input(dev):
    tiles, rows, cols, m, cnt = _case(0, 4, 100, 100, 3, 32, 32, dev)
    with pytest.raises(ValueError, match="float32"):
        blend.blend_and_count(m.double(), cnt, tiles, rows, cols)
    with pytest.raises(ValueError, match="contiguous"):
        blend.blend_and_count(m, cnt, tiles.transpose(2, 3), rows, cols)
    with pytest.raises(ValueError, match="out of range"):
        blend.blend_and_count(m, cnt, tiles, rows + 100, cols)


def test_device_mosaic_beyond_card_memory_is_not_yet_ported(dev):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        blend.DeviceMosaic(200_000, 200_000, 3, device=dev)


def test_device_mosaic_uses_kernel_on_cuda(dev):
    tiles, rows, cols, _, _ = _case(5, 8, 120, 140, 3, 32, 32, dev)
    on_card = blend.DeviceMosaic(120, 140, 3, device=dev)
    on_cpu = blend.DeviceMosaic(120, 140, 3, device="cpu")
    assert on_card.blend is blend.blend_and_count
    on_card.add_batch(tiles, rows, cols)
    on_cpu.add_batch(tiles.cpu(), rows, cols)
    for a, b in zip(on_card.finalize(), on_cpu.finalize()):
        np.testing.assert_array_equal(a, b)
