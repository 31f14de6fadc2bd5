"""The port's layout probes (clive2_tpu_torch/scripts/probe_mosaic_layouts.py
over ops/mosaic_probes.py) against the JAX package's
scripts/probe_mosaic_layouts.py.

The script's five probes are captured as it builds them (its ``probe`` is
replaced by a recorder and its ``main`` called; the script is not edited)
and run in interpret mode on the CPU, on the port's numpy-seeded inputs
cast to bf16.  The port's plain versions are held to them: the copies bit
for bit, the products within 2^-16 (|A|ᵀ|B|) elementwise (the products of
bf16 values are exact in f32; only the order of the sums differs).  The
script's ``dma64`` fails on its own store, not on the copy: the port returns
the window that exists (ROADMAP queue 3).  The kernels
(csrc/mosaic_probes.cu) run only on the card: tests/test_torch_cuda.py and
chip_smoke.py's phase ``mosaic_probes``.
"""

import ast
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clive2_tpu_torch.ops import mosaic_probes as mp
from clive2_tpu_torch.scripts import probe_mosaic_layouts as tool

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import probe_mosaic_layouts as script  # noqa: E402

TAGS = [tag for tag, _, _ in tool.PROBES]


@pytest.fixture(scope="module")
def captured():
    """{tag: (fn, args)} of the script's probes, in its order."""
    probes = {}
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(script, "probe",
                       lambda tag, fn, *args: probes.setdefault(tag,
                                                                (fn, args)))
        script.main()
    return probes


def _probe(tag):
    return next(p for p in tool.PROBES if p[0] == tag)


def _jax_inputs(tag):
    return [jnp.asarray(a).astype(jnp.bfloat16)
            for a in tool.arrays(_probe(tag)[2])]


def _run_script(captured, tag):
    fn = captured[tag][0]
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(fn)(*_jax_inputs(tag)))


def _abs_product(tag):
    """|A|ᵀ|B| (or |A||B|) in float64 from the bf16 inputs."""
    a, b = (t.double().abs().numpy() for t in tool.inputs(_probe(tag)[2],
                                                         "cpu"))
    return (a.T if tag == "dotT" else a) @ b


def test_script_probes_are_the_tools(captured):
    """The same five probes in the same order, at the same shapes and
    dtype."""
    assert list(captured) == TAGS
    for tag, kernel, shapes in tool.PROBES:
        args = captured[tag][1]
        assert tuple(a.shape for a in args) == shapes
        assert all(a.dtype == jnp.bfloat16 for a in args)


@pytest.mark.parametrize("tag", TAGS)
def test_bf16_casts_are_equal_bit_for_bit(tag):
    shapes = _probe(tag)[2]
    for want, got in zip(_jax_inputs(tag), tool.inputs(shapes, "cpu")):
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            np.asarray(want).view(np.uint16))


@pytest.mark.parametrize("tag", ["dma128", "dmaT"])
def test_copy_equals_the_script_bit_for_bit(captured, tag):
    want = _run_script(captured, tag)
    x, = tool.inputs(_probe(tag)[2], "cpu")
    got = mp.slab_copy(x).numpy()
    assert got.shape == want.shape == mp.WINDOW
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("tag", ["dotT", "dot128"])
def test_product_within_the_tolerance_of_the_script(captured, tag):
    want = _run_script(captured, tag)
    _, kernel, shapes = _probe(tag)
    got = getattr(mp, kernel)(*tool.inputs(shapes, "cpu")).numpy()
    assert got.shape == want.shape == (640, 128)
    assert (np.abs(got - want) <= 2.0 ** -16 * _abs_product(tag)).all()


@pytest.mark.parametrize("tag", ["dotT", "dot128"])
def test_plain_product_within_the_tolerance_of_float64(tag):
    """The plain version against the exact sums (float64 of the bf16
    values), so neither side's f32 order is the reference."""
    _, kernel, shapes = _probe(tag)
    args = tool.inputs(shapes, "cpu")
    a, b = (t.double().numpy() for t in args)
    exact = (a.T if tag == "dotT" else a) @ b
    got = getattr(mp, f"{kernel}_plain")(*args).numpy()
    assert got.dtype == np.float32
    assert (np.abs(got - exact) <= 2.0 ** -16 * _abs_product(tag)).all()


def test_reference_dma64_probe_fails_on_its_store(captured):
    """The script's dma64 copies fine and then stores slot[:8, :128] of a
    [640, 64] slot, an [8, 64] value, into its (8, 128) output.  The port
    returns the window that exists, x[2, :8, :64]."""
    with pytest.raises(ValueError, match="Invalid shape for `swap`"):
        _run_script(captured, "dma64")
    x, = tool.inputs(_probe("dma64")[2], "cpu")
    got = mp.slab_copy(x)
    assert got.shape == (8, 64) and got.dtype == torch.float32
    assert torch.equal(got, x[2, :8, :64].float())


@pytest.mark.parametrize("kernel", ["slab_copy", "matmul_t", "matmul"])
def test_wrappers_take_the_plain_version_on_the_cpu(kernel):
    tag = next(t for t, k, _ in tool.PROBES if k == kernel)
    args = tool.inputs(_probe(tag)[2], "cpu")
    plain = getattr(mp, f"{kernel}_plain")
    wrapper = getattr(mp, kernel)
    calls, launches = plain.calls, wrapper.launches
    got = wrapper(*args)
    assert plain.calls == calls + 1 and wrapper.launches == launches
    assert torch.equal(got, plain(*args))


@pytest.mark.parametrize("kernel", ["slab_copy", "matmul_t", "matmul"])
def test_wrappers_refuse_other_devices(kernel):
    tag = next(t for t, k, _ in tool.PROBES if k == kernel)
    args = [torch.empty(s, dtype=torch.bfloat16, device="meta")
            for s in _probe(tag)[2]]
    with pytest.raises(ValueError, match="bf16 CUDA tensors"):
        getattr(mp, kernel)(*args)


def test_tool_prints_five_oks_on_the_cpu(capsys):
    assert tool.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["devices: ['cpu']"] + [f"{t}: OK" for t in TAGS]


def test_tool_reports_a_failing_probe_and_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(mp, "matmul",
                        lambda a, b: mp.matmul_plain(a, b) + 0.1)
    assert tool.main(["--device", "cpu"]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("dot128: FAIL the product is off")
    assert lines[1:-1] == [f"{t}: OK" for t in TAGS[:-1]]


def test_tool_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.run("cuda", out=lambda line: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", ["clive2_tpu_torch/ops/mosaic_probes.py",
                                  "clive2_tpu_torch/scripts/"
                                  "probe_mosaic_layouts.py"])
def test_new_modules_import_no_jax(path):
    mods = list(_imports(os.path.join(ROOT, path)))
    assert "torch" in mods
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "clive2_tpu")]


def _source():
    csrc = os.path.join(ROOT, "clive2_tpu_torch", "csrc")
    return (open(os.path.join(csrc, "mosaic_probes.cu")).read(),
            open(os.path.join(csrc, "common.cuh")).read())


def test_kernel_source_is_a_bulk_copy_and_mma_products():
    """csrc/mosaic_probes.cu: the copy is one cp.async.bulk a block, of its
    band of rows, on the block's mbarrier (common.cuh:bulk_start,
    bulk_wait), launched as a programmatic dependent launch; the products
    are wgmma on shared memory that TMA tensor loads filled, issued as one
    committed group and waited for; no mma.sync, ldmatrix or library
    product inside."""
    src, common = _source()
    assert "bulk_start(band_bytes" in src and "bulk_wait(&bar)" in src
    assert "launch_dependent(slab_copy_kernel" in src
    assert "SmemOptIn" in src
    for ptx in ("cp.async.bulk.shared::cluster.global.mbarrier",
                "mbarrier.arrive.expect_tx", "mbarrier.try_wait.parity",
                "griddepcontrol.wait", "griddepcontrol.launch_dependents",
                "cudaLaunchAttributeProgrammaticStreamSerialization",
                "cudaFuncAttributeMaxDynamicSharedMemorySize"):
        assert ptx in common
    for ptx in ("wgmma.mma_async.sync.aligned.m64n",
                "k16.f32.bf16.bf16",
                "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier",
                "mbarrier.arrive.expect_tx", "wgmma.fence.sync.aligned",
                "wgmma.commit_group.sync.aligned",
                "wgmma.wait_group.sync.aligned 0",
                "__grid_constant__ CUtensorMap", "cuTensorMapEncodeTiled"):
        assert ptx in src
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines()).lower()
    for name in ("mma.sync", "ldmatrix", "cublas", "cutlass", "torch",
                 "#include <mma"):
        assert name not in code


def test_wrapper_steps_are_the_kernel_constants():
    """ops/mosaic_probes.py's TILE and MAX_K are the source's kBM, kBN,
    kKStep and kMaxK, and the wgmma's width is kBN."""
    src, _ = _source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert mp.TILE == dict(m=const("kBM"), n=const("kBN"),
                           k=const("kKStep"))
    assert mp.MAX_K == const("kMaxK")
    assert mp.MAX_K % mp.TILE["k"] == 0
    assert re.findall(r"wgmma\.mma_async\.sync\.aligned\.m64n(\d+)k16",
                      src) == [str(mp.TILE["n"])]


@pytest.mark.parametrize("k", [16, 48, 64, 80, 128, 256, 512])
def test_smem_bytes_is_the_sources(k):
    """ops/mosaic_probes.py:smem_bytes is what the source's mma_smem_bytes
    asks for at K, with the source's constants put in."""
    src, _ = _source()
    body = re.search(r"constexpr int mma_smem_bytes\(int k\) \{\s*"
                     r"return ([^;]+);", src).group(1)
    names = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src), k=k)
    expr = re.sub(r"\b(k\w*)\b", lambda m: str(names[m.group(1)]), body)
    # C's int division on positive operands is Python's //
    assert mp.smem_bytes(k) == eval(expr.replace("/", "//"))


# slabs whose rows split into whole bands, into bands and a shorter last
# one, into one band (smaller than a band, or rows of too few bytes), and
# slabs under the window's 8 rows: (rows, cols)
SLABS = [(640, 64), (640, 128), (64, 640), (300, 64), (113, 200),
         (9, 1000), (33, 2040), (453, 256), (640, 4), (100, 8), (7, 16),
         (5, 24), (1, 8)]


@pytest.mark.parametrize("rows, cols", SLABS)
def test_slab_bands_cover_every_row_once(rows, cols):
    """ops/mosaic_probes.py:bands, the slab copy's grid: every row in
    exactly one band, block 0's band holding the window's rows, every band
    starting on and moving a multiple of 16 bytes, each within BAND_BYTES
    unless the window's rows or the whole slab need more; and band_rows
    meets what the C entry asks of it."""
    assert 2 * rows * cols % 16 == 0 and 2 * rows * cols <= mp.MAX_SLAB_BYTES
    b = mp.band_rows(rows, cols)
    split = mp.bands(rows, cols)
    covered = [r for r0, n in split for r in range(r0, r0 + n)]
    assert covered == list(range(rows))
    assert len(split) == -(-rows // b)
    assert all(n == b for _, n in split[:-1]) and 0 < split[-1][1] <= b
    window = min(rows, mp.WINDOW[0])
    assert split[0][1] >= window
    row = 2 * cols
    for r0, n in split:
        assert r0 * row % 16 == 0 and n * row % 16 == 0
    step = 16 // int(np.gcd(row, 16))    # rows that make 16 bytes
    forced = -(-window // step) * step    # the window's rows, whole steps
    assert b * row <= mp.BAND_BYTES or b in (forced, rows)
    # the C entry's checks (csrc/mosaic_probes.cu:clive2_slab_copy)
    assert window <= b <= rows and (b == rows or 2 * b * cols % 16 == 0)


def test_script_slabs_split_across_several_blocks():
    """The script's three slabs (80-160 KB) each take several blocks of at
    most BAND_BYTES, as many as the bytes ask for."""
    for tag, kernel, shapes in tool.PROBES:
        if kernel != "slab_copy":
            continue
        rows, cols = shapes[0][1:]
        split = mp.bands(rows, cols)
        assert len(split) >= -(-2 * rows * cols // mp.BAND_BYTES) > 1, tag
        assert max(n for _, n in split) * 2 * cols <= mp.BAND_BYTES, tag
