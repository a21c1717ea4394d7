"""E6: the port's experiments/qmm_unpack_variants.py (plain versions of
both CUDA templates, the unpack helpers, check_correct, main) against the
JAX probe file as it stands, its Pallas bodies run in interpret mode.

Tolerances: the unpack helpers are exact; each body's plain version
against the Pallas body 1e-5 of the output scale (the same bf16 roundings
at the same points, the f32 dots summed in another order; measured at most
3.2e-7); check_correct's error against the JAX file's own (its K2 in
interpret mode, the port's K2 plain version) within 1e-6."""
import ast
import functools
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from chatllm_tpu_torch.experiments import qmm_unpack_variants as te6

ROOT = Path(__file__).resolve().parents[1]
PATH = ROOT / "experiments" / "qmm_unpack_variants.py"
TOL = 1e-5


@pytest.fixture(scope="module")
def e6():
    """experiments/qmm_unpack_variants.py executed as a module with
    sys.argv set to the file's name (it reads M and REPS from argv) and its
    own sys.path.insert dropped, with every pl.pallas_call in interpret
    mode."""
    from jax.experimental import pallas as pl

    tree = ast.parse(PATH.read_text(), str(PATH))
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
                         and ast.unparse(n.value.func) == "sys.path.insert")]
    mod = types.ModuleType("_jax_qmm_unpack_variants")
    mod.__file__ = str(PATH)
    saved = list(sys.argv)
    try:
        sys.argv = [str(PATH)]
        exec(compile(tree, str(PATH), "exec"), mod.__dict__)
    finally:
        sys.argv[:] = saved
    with pytest.MonkeyPatch.context() as mp:
        call = pl.pallas_call
        mp.setattr(pl, "pallas_call", lambda *a, **kw: call(*a, **{**kw, "interpret": True}))
        yield mod


def _pallas(kernel, x, q, sc, mm, d, dm, tile_k, tile_n):
    """One Pallas body over the whole product, with bench_variant's block
    specs at the given tiles (interpret mode)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    m, k = x.shape
    n = q.shape[1]
    gs = tile_k // 32
    kern = functools.partial(kernel, n_kt=k // tile_k, tile_m=m)
    xs = jnp.sum(x.reshape(m, k // 32, 32), axis=2).T
    out = pl.pallas_call(
        kern, grid=(n // tile_n, k // tile_k, 1),
        in_specs=[pl.BlockSpec((m, tile_k), lambda n_, k_, m_: (m_, k_)),
                  pl.BlockSpec((k // 32, m), lambda n_, k_, m_: (0, m_)),
                  pl.BlockSpec((tile_k // 2, tile_n), lambda n_, k_, m_: (k_, n_)),
                  pl.BlockSpec((gs, tile_n), lambda n_, k_, m_: (k_, n_)),
                  pl.BlockSpec((gs, tile_n), lambda n_, k_, m_: (k_, n_)),
                  pl.BlockSpec((gs // 8, tile_n), lambda n_, k_, m_: (k_, n_)),
                  pl.BlockSpec((gs // 8, tile_n), lambda n_, k_, m_: (k_, n_))],
        out_specs=pl.BlockSpec((m, tile_n), lambda n_, k_, m_: (0, n_)),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32),
        scratch_shapes=[pltpu.VMEM((tile_k, tile_n), jnp.bfloat16)],
        interpret=True,
    )(x, xs, q, sc, mm, jax.lax.bitcast_convert_type(d, jnp.uint16),
      jax.lax.bitcast_convert_type(dm, jnp.uint16))
    return np.asarray(out)


def _weight(k, n, m, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 255, (k // 2, n), dtype=np.uint8)
    sc = rng.integers(0, 64, (k // 32, n), dtype=np.int8)
    mm = rng.integers(0, 64, (k // 32, n), dtype=np.int8)
    d = rng.random((k // 256, n)).astype(np.float16) * np.float16(0.002)
    dm = rng.random((k // 256, n)).astype(np.float16) * np.float16(0.001)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return q, sc, mm, d, dm, x


def _rel(out, ref):
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("name", ["v0", "v1", "v2", "v3"])
def test_unpack_helpers_match_jax(e6, name):
    q = np.random.default_rng(1).integers(0, 256, (256, 128), dtype=np.uint8)
    ref = np.asarray(getattr(e6, f"unpack_{name}")(jnp.asarray(q), jnp.bfloat16)
                     .astype(jnp.float32))
    got = getattr(te6, f"unpack_{name}")(torch.from_numpy(q), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (16, 32, 128)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_unpack_v6_split_matches_jax(e6):
    q = np.random.default_rng(2).integers(0, 256, (256, 128), dtype=np.uint8)
    for ref, got in zip(e6.unpack_v6_split(jnp.asarray(q), jnp.bfloat16),
                        te6.unpack_v6_split(torch.from_numpy(q), torch.bfloat16)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("name,unpack,biasdot", te6.VARIANTS)
def test_variant_plain_matches_pallas(e6, name, unpack, biasdot):
    """Template (a) at check_correct's K 512, N 256, M 32 (one 512 x 128 tile
    per block)."""
    q, sc, mm, d, dm, x = te6.check_weight(32)
    ref = _pallas(e6.make_kernel(getattr(e6, f"unpack_{unpack}"), biasdot),
                  *(jnp.asarray(a) for a in (x, q, sc, mm, d, dm)), 512, 128)
    xt = torch.from_numpy(x)
    out = te6.qmm_unpack(xt, te6.group_sums(xt), *(torch.from_numpy(a) for a in (q, sc, mm, d, dm)),
                         unpack=unpack, biasdot=biasdot, tile_k=512)
    assert out.shape == (32, 256) and out.dtype == torch.float32
    assert _rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("mode", te6.DIAG_MODES)
def test_diag_plain_matches_pallas(e6, mode):
    """Template (b) over two k tiles of 512 rows (K 1024, N 256, M 32).
    storeonly writes only the first half of each tile's scratch: interpret
    mode leaves the rest NaN, a TPU whatever it held, the port zero.  So
    that mode runs with x's second half of every k tile at zero and the
    Pallas scratch zeroed first."""
    q, sc, mm, d, dm, x = _weight(1024, 256, 32, seed=5)
    kernel = e6.make_kernel2(mode)
    if mode == "storeonly":
        x.reshape(32, 2, 2, 256)[:, :, 1] = 0.0
        inner = kernel

        def kernel(*refs, **kw):
            refs[-1][...] = jnp.zeros(refs[-1].shape, refs[-1].dtype)
            inner(*refs, **kw)
    ref = _pallas(kernel, *(jnp.asarray(a) for a in (x, q, sc, mm, d, dm)), 512, 128)
    out = te6.qmm_unpack_diag(torch.from_numpy(x), *(torch.from_numpy(a) for a in
                                                     (q, sc, mm, d, dm)), mode=mode, tile_k=512)
    assert np.isfinite(ref).all()
    assert _rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("name,unpack,biasdot", te6.VARIANTS)
def test_check_correct_matches_jax(e6, name, unpack, biasdot):
    """The port's check (against its K2) reads the JAX file's check (against
    its K2, interpret mode) on the same seeded weight.  K2 adds the affine
    term in f32 from group sums of x, as biasdot does: those variants equal
    it (0 on both sides).  v0 rounds the term into every bf16 weight and
    misses the original's 1e-3 by design, in both packages (1.84e-3)."""
    ref = e6.check_correct(getattr(e6, f"unpack_{unpack}"), biasdot)
    err = te6.check_correct(unpack, biasdot, device="cpu")
    assert abs(err - ref) <= 1e-6
    if biasdot:
        assert err <= te6.CHECK_TOL
    else:
        assert te6.CHECK_TOL < err < 3e-3


def test_main_runs_every_variant_on_the_cpu(capsys):
    res = te6.main([], device="cpu", m=4, reps=2, k=2048, n=512)
    names = [f"diag_{m}" for m in te6.DIAG_MODES] + [v[0] for v in te6.VARIANTS]
    assert list(res) == names
    out = capsys.readouterr().out
    assert out.count(" GB/s") == len(names)
    for name in names:
        assert name in out
        assert res[name]["ms"] > 0 and res[name]["gb_s"] > 0
    assert all(res[v[0]]["err"] >= 0 for v in te6.VARIANTS)


def test_main_reads_m_and_reps_from_argv(monkeypatch):
    seen = []
    monkeypatch.setattr(te6, "bench_variant",
                        lambda name, *a, m, reps, **kw: seen.append((name, m, reps)) or {})
    monkeypatch.setattr(te6, "check_correct", lambda *a, m, **kw: seen.append(("check", m)) or 0.0)
    te6.main(["8", "3"], device="cpu")
    assert ("diag_noscale", 8, 3) in seen and ("check", 8) in seen


def test_bench_variant_raises_on_a_bad_tile():
    """The original prints an exception and carries on; the port raises."""
    with pytest.raises(ValueError):
        te6.bench_variant("v0_current", "v0", False, tile_n=500, m=2, reps=1, k=2048, n=256,
                          device="cpu")
    with pytest.raises(ValueError):
        te6.bench_variant("v0_current", "v0", False, tile_k=1000, m=2, reps=1, k=2048, n=256,
                          device="cpu")
