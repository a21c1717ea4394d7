"""E1, E3, E4 and E5: the port's plain versions against the JAX package's
probe files (experiments/gemv_probe.py, gemv_model_bench.py,
gemv_unpack.py, qmm_m32.py) at small sizes, and each probe's `main` on the
CPU.  Each JAX file is loaded as it stands, its `pl.pallas_call` run in
interpret mode from here and its module constants patched to small sizes;
gemv_unpack.py does its work at module level (a trailing `for` loop, which
is dropped before the file is executed) and it and qmm_m32.py read
`sys.argv` when imported (set to the file's name here)."""
import ast
import functools
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from chatllm_tpu_torch.experiments import gemv_model_bench as tbench
from chatllm_tpu_torch.experiments import gemv_probe as tprobe
from chatllm_tpu_torch.experiments import gemv_unpack as tunpack
from chatllm_tpu_torch.experiments import qmm_m32 as tm32
from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv_plain

ROOT = Path(__file__).resolve().parents[1]
EXP = ROOT / "experiments"
SMALL_SHAPES = [("q", 256, 256), ("k", 256, 64), ("v", 256, 64), ("o", 256, 256),
                ("gate", 256, 512), ("up", 256, 512), ("down", 512, 256)]


def _is_sys_path_insert(node) -> bool:
    return (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)
            and ast.unparse(node.value.func) == "sys.path.insert")


def _load(name: str, *, drop_trailing_for: bool = False):
    """Execute experiments/<name>.py as a module, with sys.argv set to the
    file's name.  The file's own top-level `sys.path.insert` (some name a
    fixed checkout path) is dropped, so that `chatllm_tpu` is imported from
    the checkout under test, which conftest puts first on sys.path."""
    path = EXP / f"{name}.py"
    tree = ast.parse(path.read_text(), str(path))
    if drop_trailing_for:
        assert isinstance(tree.body[-1], ast.For)
        tree.body = tree.body[:-1]
    tree.body = [node for node in tree.body if not _is_sys_path_insert(node)]
    mod = types.ModuleType(f"_jax_{name}")
    mod.__file__ = str(path)
    saved_argv = list(sys.argv)
    try:
        sys.argv = [str(path)]
        exec(compile(tree, str(path), "exec"), mod.__dict__)
    finally:
        sys.argv[:] = saved_argv
    return mod


@pytest.fixture(scope="module")
def interpret():
    from jax.experimental import pallas as pl

    with pytest.MonkeyPatch.context() as mp:
        call = pl.pallas_call
        mp.setattr(pl, "pallas_call", lambda *a, **kw: call(*a, **{**kw, "interpret": True}))
        yield pl


# ------------------------------------------------------------------- E1
@pytest.fixture(scope="module")
def e1(interpret):
    mod = _load("gemv_probe")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "K", 256)
        mp.setattr(mod, "N", 512)
        yield mod


def test_e1_stream_max_matches_pallas(e1):
    rng = np.random.default_rng(1)
    w = rng.integers(-127, 127, size=(256, 512)).astype(np.int8)
    w[:, :16] = -rng.integers(1, 127, size=(256, 16))     # columns whose max is below 0
    ref = np.asarray(e1.stream_max(jnp.asarray(w), tile_n=256, tile_k=128))
    got = tprobe.stream_max(torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (8, 512)
    np.testing.assert_array_equal(got.numpy(), ref)          # integer max: exact
    assert (ref[:, :16] == 0).all()                          # the accumulator starts at 0


def test_e1_vpu_gemv_matches_pallas(e1):
    rng = np.random.default_rng(2)
    w = rng.integers(-127, 127, size=(256, 512)).astype(np.int8)
    s = (rng.random((8, 512)) * 0.01).astype(np.float32)
    x = rng.standard_normal((256, 1)).astype(np.float32)
    ref = np.asarray(e1.vpu_gemv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                 tile_n=256, tile_k=128))
    got = tprobe.vpu_gemv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s))
    assert got.shape == ref.shape == (1, 512)
    # f32 throughout; only the order of the sums differs
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_e1_main_runs_every_variant_on_the_cpu(capsys):
    res = tprobe.main([], device="cpu", l=2, k=256, n=512, steps=2)
    assert tuple(res) == tprobe.VARIANTS
    out = capsys.readouterr().out
    assert out.count("ms/step") == 7 and out.count("tok/s @8B") == 7
    for label in ("stream_max", "vpu_gemv", "mxu_int8", "mxu_dequant", "pallas_qmm",
                  "mxu_bf16 ", "mxu_bf16_b8"):
        assert re.search(rf"^{label}", out, re.M), label
    assert "32 rows" in out                                  # the _int_mm padding is said
    # on the CPU only the eager timing: a CUDA graph needs the card
    assert out.count(" eager ") == 7 and " graph " not in out
    assert all(r["eager_ms_per_step"] > 0 and r["eager_gb_s"] > 0 for r in res.values())
    assert not any("graph_ms_per_step" in r for r in res.values())


def test_e1_names_and_sizes_are_the_originals():
    src = (EXP / "gemv_probe.py").read_text()
    assert re.search(r'\["stream", "vpu", "mxu_int8", "mxu_dequant",\s*"pallas_qmm", '
                     r'"mxu_bf16", "mxu_bf16_b8"\]', src)
    assert tprobe.VARIANTS == ("stream", "vpu", "mxu_int8", "mxu_dequant", "pallas_qmm",
                               "mxu_bf16", "mxu_bf16_b8")
    assert (tprobe.L, tprobe.K, tprobe.N, tprobe.STEPS, tprobe.GROUP) == (16, 4096, 14336, 8, 32)


# ------------------------------------------------------------------- E3
@pytest.fixture(scope="module")
def e3(interpret):
    return _load("gemv_model_bench")


def test_jax_probes_import_the_checkout_under_test(e3):
    """The original names a fixed checkout on sys.path; `_load` drops that
    line, so its JAX kernels come from this checkout."""
    for fn in (e3.qgemv_pallas, e3.qmm_pallas):
        src = Path(sys.modules[fn.__module__].__file__).resolve()
        assert src.is_relative_to(ROOT), (fn.__module__, src)


def _q4_inputs(seed: int, k: int, n: int):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, size=(k // 2, n)).astype(np.uint8)
    s = (rng.random((k // 32, n)) * 0.01 + 0.001).astype(np.float16)
    return rng, q, s


def test_e3_stream_read_matches_pallas_exactly(e3):
    k, n = 512, 256
    rng, q, s = _q4_inputs(3, k, n)
    # dyadic x in [-2, 2): every product and sum is exact in f32, so the
    # order of the 8-row sum cannot matter and the values must be equal
    x = (rng.integers(-8, 8, size=(1, k)) / 4).astype(np.float32)
    # (the original reads 8 scale rows per tile: tile_k >= 256)
    ref = np.asarray(e3.stream_read(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                    tile_n=128, tile_k=256))
    y, digest = tbench.stream_read(torch.from_numpy(x), torch.from_numpy(q),
                                   torch.from_numpy(s), tile_k=256)
    assert y.shape == ref.shape == (1, n)
    np.testing.assert_array_equal(y.numpy(), ref)
    # the side output against numpy: XOR over rows of q's and s's 32-bit words
    dq = np.bitwise_xor.reduce(q.view(np.int32), axis=0)
    ds = np.bitwise_xor.reduce(s.view(np.int32), axis=0).reshape(n // 4, 2)
    np.testing.assert_array_equal(digest.numpy(), dq ^ ds[:, 0] ^ ds[:, 1])


def test_e3_stream_read_normal_x(e3):
    """Any x: the 8 rows are summed in order here and in XLA's order there."""
    k, n = 1024, 256
    rng, q, s = _q4_inputs(4, k, n)
    x = rng.standard_normal((1, k)).astype(np.float32)
    ref = np.asarray(e3.stream_read(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                    tile_n=128, tile_k=256))
    y, _ = tbench.stream_read(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
                              tile_k=256)
    assert np.abs(y.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


# The JAX reference runs the bf16 body under XLA on the CPU, which may keep
# excess precision between bf16 operations; the port rounds after every
# one.  Measured: no gap at all (bit-equal outputs for 6 seeds at K 512,
# 2048 and 4096 with tile_k 128 to 2048), so the limit is equality.


@pytest.mark.parametrize("tile_k", [128, 256])
def test_e3_qgemv_bf16_matches_pallas(e3, tile_k):
    k, n = 512, 256
    rng, q, s = _q4_inputs(5, k, n)
    x = rng.standard_normal((1, k)).astype(np.float32)
    ref = np.asarray(e3.qgemv_bf16(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                   tile_n=128, tile_k=tile_k))
    got = tbench.qgemv_bf16(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
                            tile_k=tile_k)
    assert got.shape == ref.shape == (1, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # and the bf16 math is that of the q4 GEMV: within bf16 rounding of K1's
    # f32 product (no zero point, f16 scales)
    k1 = qgemv_plain(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
                     group=32, packed=True, zero_point=0).numpy()
    assert np.abs(got.numpy() - k1).max() <= 2e-2 * np.abs(k1).max()


def test_e3_qgemv_bf16_rounds_every_step():
    """The plain version rounds to bf16 after each operation of the tile:
    recomputing one column by hand with numpy's bf16 emulation gives the
    same bits."""
    k, n, tile_k = 256, 32, 128
    rng, q, s = _q4_inputs(6, k, n)
    x = rng.standard_normal((1, k)).astype(np.float32)
    got = tbench.qgemv_bf16(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
                            tile_k=tile_k).numpy()[0]

    def bf(v):
        return torch.tensor(v, dtype=torch.float32).to(torch.bfloat16).float().item()

    col = 7
    xb = [bf(v) for v in x[0]]
    acc = [0.0] * 8
    for kt in range(k // tile_k):
        ts = []
        for g in range(tile_k // 32):
            base = kt * tile_k + g * 32
            rows = [q[(base // 2) + j, col] for j in range(16)]
            p = [bf(bf((b & 15) * xb[base + j]) + bf((b >> 4) * xb[base + 16 + j]))
                 for j, b in enumerate(rows)]
            sc = bf(float(s[base // 32, col]))
            ts.append([bf(bf(p[r] + p[r + 8]) * sc) for r in range(8)])
        while len(ts) > 1 and len(ts) % 2 == 0:
            h = len(ts) // 2
            ts = [[bf(a + b) for a, b in zip(ts[i], ts[i + h])] for i in range(h)]
        for r in range(8):
            acc[r] = float(np.float32(acc[r]) + np.float32(ts[0][r]))
    want = np.float32(acc[0])
    for r in range(1, 8):
        want = np.float32(want + np.float32(acc[r]))
    assert got[col] == want


def test_e3_make_weights_bit_exact(e3, capsys):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(e3, "L", 2)
        mp.setattr(e3, "SHAPES", SMALL_SHAPES)
        ref, ref_total = e3.make_weights()
    got, total = tbench.make_weights(2, SMALL_SHAPES, "cpu")
    assert total == ref_total
    for name, _, _ in SMALL_SHAPES:
        rq, rs = (np.asarray(a) for a in ref[name])
        gq, gs = got[name]
        assert gq.dtype == torch.uint8 and gs.dtype == torch.float16
        np.testing.assert_array_equal(gq.numpy(), rq)
        np.testing.assert_array_equal(gs.view(torch.int16).numpy(), rs.view(np.int16))


def test_e3_make_weights_sizes_at_the_defaults():
    q_bytes = sum(tbench.L * k // 2 * n for _, k, n in tbench.SHAPES)
    s_bytes = sum(tbench.L * k // 32 * n * 2 for _, k, n in tbench.SHAPES)
    assert (q_bytes, s_bytes) == (3_489_660_928, 436_207_616)


def test_e3_main_runs_every_variant_on_the_cpu(capsys):
    specs = ["vpu", "stream:1024:128", "vpu_bf16:1024:128:16", "mxu"]
    res = tbench.main(["sweep", *specs], device="cpu", l=2, shapes=SMALL_SHAPES, tokens=2)
    assert list(res) == specs
    out = capsys.readouterr().out
    for name in ("vpu", "stream", "vpu_bf16", "mxu"):
        assert re.search(rf"^\[{name} eager\] [0-9.]+ ms/token -> [0-9.]+ tok/s "
                         r"\([0-9]+ GB/s eff, [0-9.]+B params\)$", out, re.M), name
    assert "[vpu_bf16 tn=1024 tk=128 vm=16]" in out
    assert all(r["eager_ms_per_token"] > 0 for r in res.values())
    # the single-kernel form
    res = tbench.main(["stream", "512", "256"], device="cpu", l=1, shapes=SMALL_SHAPES,
                      tokens=1)
    assert list(res) == ["stream"]


def test_e3_names_and_sizes_are_the_originals():
    src = (EXP / "gemv_model_bench.py").read_text()
    for name in ("vpu", "stream", "vpu_bf16"):
        assert f'kernel_name == "{name}"' in src
    assert "gemv_model_bench.py mxu" in src             # the original's fall-through
    assert tbench.VARIANTS == ("vpu", "stream", "vpu_bf16", "mxu")
    assert (tbench.L, tbench.H, tbench.KV, tbench.F, tbench.G, tbench.TOKENS) == (
        32, 4096, 1024, 14336, 32, 32)


def test_e3_tile_k_must_divide_k():
    q = torch.zeros(128, 64, dtype=torch.uint8)
    s = torch.zeros(8, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="tile_k"):
        tbench.qgemv_bf16(torch.zeros(256), q, s, tile_k=96)


# ------------------------------------------------------------------- E4
@pytest.fixture(scope="module")
def e4(interpret):
    return _load("gemv_unpack", drop_trailing_for=True)


def _jax_unpack(mod, mode, x, q, sc, m, d, dm, *, tile_k, tile_n):
    """The original's kernel body through `bench`'s pallas_call specs."""
    k2, n = q.shape
    k = 2 * k2
    gs = tile_k // 32
    kern = functools.partial(mod.make_kernel(mode), n_kt=k // tile_k)
    pl, pltpu = mod.pl, mod.pltpu
    return np.asarray(pl.pallas_call(
        kern, grid=(n // tile_n, k // tile_k),
        in_specs=[pl.BlockSpec((tile_k, 1), lambda i, j: (j, 0)),
                  pl.BlockSpec((tile_k // 2, tile_n), lambda i, j: (j, i)),
                  pl.BlockSpec((gs, tile_n), lambda i, j: (j, i)),
                  pl.BlockSpec((gs, tile_n), lambda i, j: (j, i)),
                  pl.BlockSpec((gs // 8, tile_n), lambda i, j: (j, i)),
                  pl.BlockSpec((gs // 8, tile_n), lambda i, j: (j, i))],
        out_specs=pl.BlockSpec((8, tile_n), lambda i, j: (0, i)),
        out_shape=jax.ShapeDtypeStruct((8, n), jnp.float32),
        scratch_shapes=[pltpu.VMEM((8, tile_n), jnp.float32)],
    )(jnp.asarray(x).reshape(k, 1), jnp.asarray(q), jnp.asarray(sc), jnp.asarray(m),
      jax.lax.bitcast_convert_type(jnp.asarray(d), jnp.uint16),
      jax.lax.bitcast_convert_type(jnp.asarray(dm), jnp.uint16)))


@pytest.fixture(scope="module")
def q4k_small():
    from chatllm_tpu.models.synthetic import synth_linear

    rng = np.random.default_rng(7)
    lin = synth_linear(512, 256, "q4k", zeros=False, rng=rng)
    x = rng.standard_normal(512).astype(np.float32)
    return x, tuple(np.array(a) for a in (lin.q, lin.s, lin.b, lin.d, lin.dm))


@pytest.mark.parametrize("mode", tunpack.MODES)
def test_e4_modes_match_pallas(e4, q4k_small, mode):
    x, arrays = q4k_small
    ref = _jax_unpack(e4, mode, x, *arrays, tile_k=256, tile_n=128)
    ta = [torch.from_numpy(a) for a in arrays]
    got = tunpack.unpack_gemv(torch.from_numpy(x), *ta, mode=mode)
    assert got.shape == ref.shape == (8, 256) and got.dtype == torch.float32
    # f32 throughout; the order of the sums (and v3's algebra) differ
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    # the 8 rows add up to the q4_k GEMV: K1's plain version, 1e-4 of its scale
    q, sc, m, d, dm = ta
    k1 = qgemv_plain(torch.from_numpy(x)[None], q, sc, m, group=32, packed=True,
                     zero_point=0, d=d, dm=dm, sb=8)
    y = got.sum(dim=0, keepdim=True)
    assert (y - k1).abs().max().item() <= 1e-4 * k1.abs().max().item()


def test_e4_check_and_main_on_the_cpu(capsys):
    for mode in tunpack.MODES:
        assert tunpack.check(mode, device="cpu") < tunpack.CHECK_TOL
    res = tunpack.main(["2"], device="cpu", k=512, n=256)
    assert tuple(res) == tunpack.MODES
    out = capsys.readouterr().out
    for mode in tunpack.MODES:
        assert re.search(rf"^{mode}: +[0-9.]+ ms +[0-9.]+ GB/s$", out, re.M), mode
        assert res[mode]["err"] < 1e-4 and res[mode]["ms"] > 0


def test_e4_names_and_sizes_are_the_originals():
    src = (EXP / "gemv_unpack.py").read_text()
    assert 'for mode in ("v0", "v1", "v2", "v3"):' in src
    assert (tunpack.REPS, tunpack.K, tunpack.N, tunpack.GROUP, tunpack.SB) == (
        2048, 4096, 14336, 32, 8)


# ------------------------------------------------------------------- E5
@pytest.fixture(scope="module")
def e5(interpret):
    return _load("qmm_m32")


def test_e5_dma_pass_matches_pallas(e5):
    k, n, tile_k, tile_n = 512, 256, 64, 128
    q = np.random.default_rng(8).integers(0, 256, size=(k // 2, n)).astype(np.uint8)
    c = np.float32(0.75)
    pl, pltpu = e5.pl, e5.pltpu
    ref = np.asarray(pl.pallas_call(
        e5._dma_kernel, grid=(n // tile_n, k // 2 // tile_k),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec((tile_k, tile_n), lambda i, j: (j, i),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1), lambda i, j: (0, 0), memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
    )(jnp.full((1, 1), c), jnp.asarray(q)))[0, 0]
    sums = tm32.dma_sums(torch.from_numpy(q), torch.tensor([c]), tile_k=tile_k, tile_n=tile_n)
    assert sums.shape == (n // tile_n, k // 2 // tile_k)
    assert sums[-1, -1].item() == ref                        # the last tile's: exact
    tiles = q.reshape(k // 2 // tile_k, tile_k, n // tile_n, tile_n).astype(np.int64)
    np.testing.assert_array_equal(sums.numpy(), tiles.sum(axis=(1, 3)).T.astype(np.float32) + c)


def test_e5_main_on_the_cpu(capsys):
    res = tm32.main(device="cpu", m=32, reps=2, k=2048, n=1024)
    assert list(res) == ["dma", *tm32.FORMATS]
    out = capsys.readouterr().out
    assert re.search(r"^DMA-only +K=2048 N=1024 tk=1024 tn=512: +[0-9.]+ ms +[0-9.]+ GB/s$",
                     out, re.M)
    for fmt in tm32.FORMATS:
        assert re.search(rf"^qmm {fmt} +M=32 K=2048 N=1024 default +: +[0-9.]+ ms", out, re.M)
    assert out.count("takes no such argument") == 6


def test_e5_names_and_sizes_are_the_originals():
    src = (EXP / "qmm_m32.py").read_text()
    assert 'for fmt in ("q4k", "q8", "q4"):' in src
    for key, val in tm32.SWEEP:
        assert re.search(rf"for t{key[5]} in \([0-9, ]*\b{val}\b", src), (key, val)
    assert (tm32.M, tm32.REPS, tm32.DMA_TILE_K, tm32.DMA_TILE_N) == (32, 2048, 1024, 512)


# ---------------------------------------------------------------- devices
@pytest.mark.parametrize("run", [
    lambda: tprobe.main(["stream"]),
    lambda: tbench.main(["stream"]),
    lambda: tunpack.main(["2"]),
    lambda: tm32.main(reps=2),
], ids=["e1", "e3", "e4", "e5"])
def test_mains_need_a_card_unless_told(run):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run()
