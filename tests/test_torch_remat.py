"""PyTorch port: ``build_unet(remat=True)`` (``torch.utils.checkpoint`` around
every encoder ResBlock and every UnetBlock) against ``remat=False`` and
against the JAX package's ``nn.remat``, on the CPU.

The recompute in the backward launches the BatchNorm statistics again but
must not move the running statistics, nor the attention's power
iteration, a second time: flax's lifted remat writes its variables once.
"""

import numpy as np
import pytest
import torch

from unet_tpu_torch.models import build_unet, init_weights
from unet_tpu_torch.models.layers import BatchNorm, SelfAttention
from unet_tpu_torch.ops import bn as tbn
from unet_tpu_torch.train import losses as tl
from unet_tpu_torch.train.checkpoint import from_flax_variables, to_flax_variables

torch.set_num_threads(2)


def _step(model, x, y):
    """A training forward, weighted CE on the folded logits, backward:
    (loss, gradients, state after) and the forward sums' count."""
    calls = []

    def counted(t):
        calls.append(t.shape)
        return tbn.bn_sum_sumsq(t)

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.reductions = (counted, tbn.bn_bwd_sums)
    logits = model(x, fold_logits=True)
    if logits.shape[-1] != y.shape[-1]:
        logits, y = tl.fold_loss_layout(logits, y)
    loss = tl.cross_entropy(logits, y, torch.tensor([0.2, 0.5, 0.3]))
    loss.backward()
    return (loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()}, len(calls))


@pytest.mark.parametrize("topology", ["tpu_opt", "parity_sa"])
def test_remat_equals_no_remat(topology):
    """Same weights and batch, float32: the loss, every gradient and every
    running statistic and u vector after the step bit-equal with and
    without remat, the statistics moved once from their init; the forward
    sums run once a site, plus once a site inside a recomputed block."""
    kw = (dict(tpu_opt=True) if topology == "tpu_opt"
          else dict(tpu_opt=False, self_attention=True))
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 3, (2, 64, 64), generator=torch.Generator().manual_seed(2))
    runs = {}
    for remat in (False, True):
        model = build_unet("xresnet18", n_out=3, c_in=3, dtype=torch.float32, remat=remat,
                           **kw)
        init_weights(model, torch.Generator().manual_seed(0))
        for m in model.modules():
            if isinstance(m, SelfAttention):
                m.gamma.data.fill_(0.5)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        runs[remat] = _step(model.train(), x, y)
    (l0, g0, s0, n0), (l1, g1, s1, n1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    stats = [k for k in s0 if "running" in k or k.endswith("_u")]
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert all(not torch.equal(s1[k], before[k]) for k in stats if "running" in k)
    sites = sum(isinstance(m, BatchNorm) for m in model.modules())
    blocks = [model.encoder.get_submodule(n) for names in model.encoder.block_names
              for n in names] + [model.get_submodule(f"up_{i}") for i in range(model.n_up)]
    inside = sum(isinstance(m, BatchNorm) for b in blocks for m in b.modules())
    assert (n0, n1) == (sites, sites + inside) and inside > 0
    if topology == "parity_sa":
        assert any(k.endswith("_u") and not torch.equal(s1[k], before[k]) for k in stats)


def test_remat_matches_jax_remat():
    """The port's remat step (float32) against JAX's ``build_unet(remat=True)``
    at float64 (the trainer tests' reference: JAX's float32 gradients of the
    folded stem drift ~4e-2 at this size): loss within rtol 1e-5, each
    parameter's gradient within 1e-3 relative L2, the updated running
    statistics within 1e-5."""
    import jax
    import jax.numpy as jnp

    from test_torch_train import _randomize
    from unet_tpu.models import build_unet as jax_build_unet
    from unet_tpu.train import losses as jl

    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, size=(2, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=(2, 64, 64)).astype(np.int32)
    weight = np.array([0.2, 0.5, 0.3], np.float32)
    init = jax_build_unet("xresnet18", n_out=3, c_in=3, dtype=jnp.float32, tpu_opt=True)
    v = _randomize(jax.jit(lambda k: init.init(k, x, train=False))(jax.random.PRNGKey(0)),
                   rng)  # jit: one compile, the eager init's values bit for bit
    with jax.enable_x64():
        jmodel = jax_build_unet("xresnet18", n_out=3, c_in=3, dtype=jnp.float64,
                                tpu_opt=True, remat=True)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        loss_fn = jl.build_loss(None, False, jnp.asarray(weight, jnp.float64))

        def forward_loss(params, batch_stats, images, masks):
            logits, updates = jmodel.apply({"params": params, "batch_stats": batch_stats},
                                           images, train=True, fold_logits=True,
                                           mutable=["batch_stats"])
            logits, masks = jl.fold_loss_layout(logits, masks)
            return loss_fn(logits, masks), updates["batch_stats"]

        (want_loss, want_stats), want_grads = jax.jit(jax.value_and_grad(
            forward_loss, has_aux=True))(v64["params"], v64["batch_stats"],
                                        jnp.asarray(x, jnp.float64), jnp.asarray(y))
        want_grads = jax.tree_util.tree_map(np.asarray, want_grads)
        want_stats = jax.tree_util.tree_map(np.asarray, want_stats)

    model = build_unet("xresnet18", n_out=3, c_in=3, dtype=torch.float32, remat=True).train()
    model.load_state_dict({k: torch.from_numpy(np.array(a))
                           for k, a in from_flax_variables(v).items()})
    logits = model(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))),
                   fold_logits=True)
    loss = tl.cross_entropy(*tl.fold_loss_layout(logits, torch.from_numpy(y).long()),
                            torch.from_numpy(weight))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    sd = dict(model.state_dict())
    sd.update({n: p.grad for n, p in model.named_parameters()})
    got = to_flax_variables(sd)
    flat_g = jax.tree_util.tree_flatten_with_path(got["params"])[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert rel <= 1e-3, (jax.tree_util.keystr(path), rel)
    for (path, s), (_, w) in zip(jax.tree_util.tree_flatten_with_path(got["batch_stats"])[0],
                                 jax.tree_util.tree_flatten_with_path(want_stats)[0]):
        np.testing.assert_allclose(s, w, rtol=1e-5, atol=1e-5, err_msg=jax.tree_util.keystr(path))
