"""The port's gradient compression with error feedback
(``repro_torch.optim.grad_compress``) against the JAX package's
(``repro.optim.grad_compress``), on the CPU.

Gradients are made with NumPy from a seed and handed to both; the
reference's grad_dct kernels run in interpret mode.  Bounds: where the
two agree on every code of a 64-sample row, projections and error
feedback agree within atol 1e-5 (the reference's decode bound); a code
may differ by +-1 on at most 1 in 10^4 codes, because XLA and torch sum
a coefficient's products in different orders
(``tests/test_torch_grad_dct.py``), and a row with such a code may move
by at most one quantisation step (its scale).  bf16 gradients may also
round to the neighbouring bf16 value (2^-8 relative).
"""

import importlib.util
import math
import pathlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jconfigs
from repro.kernels import grad_dct as jgd
from repro.models import registry as jmodels
from repro.optim import grad_compress as jgc
from repro_torch.kernels import grad_dct as tgd
from repro_torch.optim import grad_compress as tgc

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEEP = 16

# leaf -> (shape, dtype): two f32 leaves (one with a 6-sample tail), one
# under min_size and one bf16
TREE = {"blocks/w": ((2, 48, 64), np.float32),
        "embed": ((70, 65), np.float32),
        "norm": ((64,), np.float32),
        "head": ((72, 64), ml_dtypes.bfloat16)}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {p: rng.standard_normal(shape).astype(np.float32).astype(dt)
            for p, (shape, dt) in TREE.items()}


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _assert_projection_close(got, want, corrected, keep, rtol=0.0):
    """Flat projections (or error feedback) of one leaf: atol 1e-5 (plus
    ``rtol``) on rows whose codes agree; a row with a flipped code moves
    by at most its scale; the sub-block tail is exact."""
    got, want = _np32(got).reshape(-1), _np32(want).reshape(-1)
    corrected = _np32(corrected).reshape(-1)
    r = got.size // 64
    assert np.array_equal(got[r * 64:], want[r * 64:])
    diff = np.abs(got[:r * 64] - want[:r * 64]).reshape(r, 64)
    off = (diff > 1e-5 + rtol * np.abs(want[:r * 64]).reshape(r, 64)).any(1)
    assert off.sum() <= math.ceil(1e-4 * r * keep)
    scale = np.asarray(jgd.encode(corrected, keep=keep).scale).reshape(-1)
    assert (diff[off].max(1, initial=0) <= scale[off] * (1 + 1e-6)).all()


def _assert_step_close(got, want, grads, ef, cfg):
    new_g, new_ef = got
    want_g, want_ef = want
    for p, g in grads.items():
        if g.size < cfg.min_size:
            continue
        corrected = np.asarray(g).astype(np.float32) + _np32(ef[p])
        assert new_g[p].dtype == (torch.bfloat16 if TREE[p][1] is
                                  ml_dtypes.bfloat16 else torch.float32)
        assert new_ef[p].dtype == torch.float32
        assert tuple(new_g[p].shape) == tuple(want_g[p].shape)
        rtol = 2.0 ** -8 if new_g[p].dtype == torch.bfloat16 else 0.0
        _assert_projection_close(new_g[p], want_g[p], corrected, cfg.keep,
                                 rtol)
        _assert_projection_close(new_ef[p], want_ef[p], corrected, cfg.keep)


def test_project_tree_matches_reference_over_three_steps():
    cfg_t = tgc.GradCompressConfig(enabled=True, keep=KEEP)
    cfg_j = jgc.GradCompressConfig(enabled=True, keep=KEEP)
    ef_j = {p: jnp.zeros(shape, jnp.float32)
            for p, (shape, _) in TREE.items()}
    ef_t = tgc.init_error_feedback(tgc.from_numpy_tree(_grads(0), "cpu"))
    ef_own = ef_t
    for step in range(3):
        grads = _grads(step)
        want = jgc.project_tree({p: jnp.asarray(g) for p, g in
                                 grads.items()}, ef_j, cfg_j)
        g_t = tgc.from_numpy_tree(grads, "cpu")
        # the reference's state carried across, one step at a time
        got = tgc.project_tree(g_t, ef_t, cfg_t)
        _assert_step_close(got, want, grads, ef_j, cfg_t)
        # the port's own state, carried through all three steps
        own = tgc.project_tree(g_t, ef_own, cfg_t)
        _assert_step_close(own, want, grads, ef_j, cfg_t)
        # the leaf under min_size passes through with its error feedback
        assert got[0]["norm"] is g_t["norm"] and got[1]["norm"] is ef_t[
            "norm"]
        ef_j = want[1]
        ef_t = tgc.from_numpy_tree({p: np.asarray(e) for p, e in
                                    ef_j.items()}, "cpu")
        ef_own = own[1]
    # three steps of feedback have left a residual in every large leaf
    for p, (shape, _) in TREE.items():
        nonzero = bool(ef_own[p].abs().max() > 0)
        assert nonzero == (math.prod(shape) >= cfg_t.min_size)


def test_error_feedback_is_corrected_minus_projection_exactly():
    cfg = tgc.GradCompressConfig(enabled=True, keep=KEEP)
    grads = tgc.from_numpy_tree(_grads(0), "cpu")
    ef = {p: torch.from_numpy(
        np.random.default_rng(7).standard_normal(g.shape).astype(np.float32))
        for p, g in grads.items()}
    new_g, new_ef = tgc.project_tree(grads, ef, cfg)
    for p in ("blocks/w", "embed", "head"):
        corrected = grads[p].float() + ef[p]
        proj = tgc.project_leaf(corrected, KEEP)
        assert torch.equal(new_ef[p], corrected - proj)
        assert torch.equal(new_g[p], proj.to(grads[p].dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_leaf_matches_reference(dtype):
    g = np.random.default_rng(3).standard_normal((40, 96)).astype(
        np.float32).astype(getattr(ml_dtypes, dtype, np.float32))
    want = jgc.project_leaf(jnp.asarray(g), KEEP)
    got = tgc.project_leaf(tgc.from_numpy_tree({"g": g}, "cpu")["g"], KEEP)
    assert str(got.dtype) == f"torch.{dtype}" and got.shape == want.shape
    _assert_projection_close(got, want, g, KEEP,
                             2.0 ** -8 if dtype == "bfloat16" else 0.0)


def test_config_and_error_feedback_init_match_reference():
    t, j = tgc.GradCompressConfig(), jgc.GradCompressConfig()
    assert (t.enabled, t.keep, t.axis, t.min_size, t.ratio) == (
        j.enabled, j.keep, j.axis, j.min_size, j.ratio)
    for keep in (8, 16, 64):
        assert tgc.GradCompressConfig(keep=keep).ratio == \
            jgc.GradCompressConfig(keep=keep).ratio
    params = tgc.from_numpy_tree(_grads(1), "cpu")
    ef = tgc.init_error_feedback(params)
    want = jgc.init_error_feedback({p: jnp.asarray(g) for p, g in
                                    _grads(1).items()})
    for p in TREE:
        assert ef[p].dtype == torch.float32 and not ef[p].any()
        assert tuple(ef[p].shape) == tuple(want[p].shape)


def test_from_numpy_tree_keeps_bits():
    tree = _grads(2)
    got = tgc.from_numpy_tree(tree, "cpu")
    for p, a in tree.items():
        assert np.array_equal(got[p].float().numpy(), a.astype(np.float32))
    assert got["head"].dtype == torch.bfloat16
    before = dict(tgd.launches)
    tgc.project_tree(got, tgc.init_error_feedback(got),
                     tgc.GradCompressConfig(keep=KEEP))
    assert tgd.launches == before          # the plain version on the CPU


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_tables_are_smollm_360m():
    # chip_smoke.py projects SmolLM-360M's full gradient tree and
    # compresses its KV cache at batch 8 and 2048 positions; its tables
    # must be the reference model's
    cs = _chip_smoke()
    cfg = jconfigs.get("smollm-360m")
    specs = jmodels.param_specs(cfg)
    assert cs.SMOLLM_360M_GRADS == {p: tuple(s.shape)
                                    for p, s in specs.items()}
    assert all(s.dtype == jnp.float32 for s in specs.values())
    compressed = [math.prod(s) for s in cs.SMOLLM_360M_GRADS.values()
                  if math.prod(s) >= tgc.GradCompressConfig().min_size]
    assert len(compressed) == 10 and sum(compressed) == 361_820_160
    assert sum(n // 64 for n in compressed) == 5_653_440
    cache = jmodels.abstract_cache(cfg, 8, 2048)
    assert sorted(cache) == ["k", "v"]
    for a in cache.values():
        assert tuple(a.shape) == cs.SMOLLM_360M_KV
        assert a.dtype == jnp.bfloat16
