"""A torch model of the SSD kernels' arithmetic against the plain version
and the reference, on the CPU.

``csrc/ssd.cu`` computes the chunked scan in three passes (chunk states in
parallel over chunks, an ordered state pass, outputs in parallel over
chunks) with every product on the tensor cores in TF32, each float32
operand split in a TF32 hi and lo half.  :func:`model` repeats that
arithmetic with torch on the CPU: the operands of each product rounded as
the kernel rounds them (round to nearest, ties away, 10 mantissa bits),
L as 2^(log2(e) cum_i - log2(e) cum_j), exp(cum) applied after C state.
It is held against the plain version (``ssd_chunked_ref``) and the
reference's scan (Pallas in interpret mode) at the reference's tolerance
5e-4 on the reference's four SSD_CASES and on a shape like mamba2's (N 128,
P 64, chunk 128, bf16 B/C); the same model with one TF32 pass per product
fails that tolerance there, which is why the kernels split.  The kernels'
tile constants and the library's interface are checked against the CUDA
source, ``chip_smoke.py``'s build report of the SSD kernels against a
ptxas log and its choice of interface for ``--against``, and the wrapper's
refusal of rows the kernels' 16-byte loads cannot read.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.ssd.ops import ssd as r_ssd  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd import ssd_chunked_ref  # noqa: E402

# the reference's SSD_CASES (tests/test_kernels.py:75-80): (B, S, H, P, N,
# chunk, dtype x is drawn in); and a shape like mamba2-130m's scan, batch
# and sequence cut (its 24 heads to 4)
SSD_CASES = [(2, 256, 3, 32, 16, 64, "float32"),
             (1, 128, 2, 64, 32, 32, "float32"),
             (2, 200, 2, 32, 16, 64, "float32"),
             (2, 256, 4, 64, 16, 128, "bfloat16")]
MAIN_LIKE = (4, 2048, 4, 64, 128, 128, "float32")
SSD_TOL = 5e-4                  # the reference's, atol and rtol
LOG2E = np.float32(1.4426950408889634)


def tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties
    away from zero, 10 explicit mantissa bits."""
    i = v.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, split: bool, a_exact=False, b_exact=False):
    """a @ b as the kernels take it on the tensor cores: with ``split``
    each inexact operand is hi + lo and the product lo*hi + hi*lo + hi*hi
    (an exact operand, a bf16 value, is its own hi); without, one TF32
    pass."""
    if not split:
        return tf32(a) @ tf32(b)
    ah, bh = tf32(a), tf32(b)
    out = ah @ bh
    if not b_exact:
        out = ah @ tf32(b - bh) + out
    if not a_exact:
        out = tf32(a - ah) @ bh + out
    return out


def model(x, a, Bm, Cm, *, chunk: int, n_heads: int, split: bool = True):
    """x: [BH, S, P]; a: [BH, S]; Bm/Cm: [B, S, N] (float32 or bf16).
    Returns (y [BH, S, P], final state [BH, N, P]) computed as the three
    passes of csrc/ssd.cu compute them."""
    BH, S, P = x.shape
    B, _, N = Bm.shape
    Q, nc = chunk, S // chunk
    exact = Bm.dtype == torch.bfloat16
    rows = torch.arange(BH) // n_heads
    xc = x.reshape(BH, nc, Q, P)
    Bc = Bm.float().reshape(B, nc, Q, N)
    Cc = Cm.float().reshape(B, nc, Q, N)
    # ssd_prep
    cum = a.reshape(BH, nc, Q).cumsum(-1)
    last = cum[..., -1:]
    c2, ecum = cum * LOG2E, torch.exp(cum)
    dte, dec = torch.exp(last - cum), torch.exp(last[..., 0])
    # ssd_chunk_state: B^T (exp(cum[-1] - cum) * x)
    Sc = product(Bc[rows].transpose(-1, -2), dte[..., None] * xc, split,
                 a_exact=exact)
    # ssd_state_pass: the state entering each chunk
    entering = torch.empty_like(Sc)
    s = torch.zeros((BH, N, P))
    for c in range(nc):
        entering[:, c] = s
        s = s * dec[:, c, None, None] + Sc[:, c]
    # ssd_chunk_out: exp(cum) (C state) + (G * L) x
    G = product(Cc, Bc.transpose(-1, -2), split, exact, exact)[rows]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.where(tri, torch.exp2(c2[..., :, None] - c2[..., None, :]),
                    torch.zeros(()))
    y = ecum[..., None] * product(Cc[rows], entering, split, a_exact=exact)
    y = product(G * L, xc, split) + y
    return y.reshape(BH, S, P), s


def _inputs(B, S, H, P, N, x_dtype, bc_dtype, seed=0):
    """x [B, S, H, P], a [B, S, H] <= 0 and B/C [B, S, N] as float32 numpy
    arrays from a seed (the reference's test inputs), values representable
    in the stated dtypes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((B, S, H))) * 0.1).astype(np.float32)
    bm = rng.standard_normal((B, S, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, N)).astype(np.float32)
    if x_dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    if bc_dtype == "bfloat16":
        bm, cm = (np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
                  for v in (bm, cm))
    return x, a, bm, cm


def _rows(arrays, chunk, bc_dtype):
    """The port's [BH, S, P] / [BH, S] rows and B/C, S padded to a multiple
    of the chunk as ops.ssd pads it."""
    x, a, bm, cm = (torch.from_numpy(v) for v in arrays)
    B, S, H, P = x.shape
    pad = (-S) % chunk
    F = torch.nn.functional
    x, a = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(a, (0, 0, 0, pad))
    bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    dt = getattr(torch, bc_dtype)
    return (x.transpose(1, 2).reshape(B * H, S + pad, P),
            a.transpose(1, 2).reshape(B * H, S + pad), bm.to(dt), cm.to(dt))


def _layout(y, fs, B, S, H):
    """[BH, S', P] / [BH, N, P] back to ops.ssd's [B, S, H, P] /
    [B, H, P, N]."""
    P = y.shape[-1]
    return (y.reshape(B, H, -1, P).transpose(1, 2)[:, :S].numpy(),
            fs.reshape(B, H, -1, P).transpose(-1, -2).numpy())


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=SSD_TOL,
                                   rtol=SSD_TOL)


_REF = {}


def _reference(case, bc_dtype):
    """The reference's ops.ssd (its Pallas kernel in interpret mode) on the
    case's inputs, once per case."""
    key = (case, bc_dtype)
    if key not in _REF:
        B, S, H, P, N, Q, x_dtype = case
        arrays = _inputs(B, S, H, P, N, x_dtype, bc_dtype)
        x, a, bm, cm = (jnp.asarray(v) for v in arrays)
        dt = getattr(jnp, bc_dtype)
        with jax.threefry_partitionable(False):
            y, fs = r_ssd(x, a, bm.astype(dt), cm.astype(dt), chunk=Q)
        _REF[key] = (arrays, (np.asarray(y), np.asarray(fs)))
    return _REF[key]


@pytest.mark.parametrize("bc_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES + [MAIN_LIKE],
                         ids=lambda c: "B{}_S{}_H{}_P{}_N{}_Q{}_{}".format(*c))
def test_model_matches_plain_and_reference(case, bc_dtype):
    """The kernels' arithmetic (split TF32) against the plain version and
    the reference at 5e-4."""
    B, S, H, P, N, Q, _ = case
    arrays, want = _reference(case, bc_dtype)
    rows = _rows(arrays, Q, bc_dtype)
    got = _layout(*model(*rows, chunk=Q, n_heads=H), B, S, H)
    plain = _layout(*ssd_chunked_ref(*rows, chunk=Q, n_heads=H), B, S, H)
    _check(got, plain)
    _check(got, want)


def test_one_tf32_pass_misses_the_tolerance():
    """The same arithmetic with one TF32 pass per product fails 5e-4 at
    the mamba2-like shape (bf16 B/C): the split is needed."""
    B, S, H, P, N, Q, _ = MAIN_LIKE
    arrays, want = _reference(MAIN_LIKE, "bfloat16")
    rows = _rows(arrays, Q, "bfloat16")
    y1, fs1 = _layout(*model(*rows, chunk=Q, n_heads=H, split=False), B, S,
                      H)
    ys, fss = _layout(*model(*rows, chunk=Q, n_heads=H), B, S, H)
    err1 = np.abs(y1 - want[0]).max()
    errs = np.abs(ys - want[0]).max()
    assert not np.allclose(y1, want[0], atol=SSD_TOL, rtol=SSD_TOL)
    assert err1 > 10 * errs, (err1, errs)


def test_tf32_rounding():
    """tf32 keeps 10 mantissa bits, rounds to nearest with ties away from
    zero, and a split's halves add back to within 2^-22 relative."""
    one = 1.0
    half_ulp = 2.0 ** -11
    v = torch.tensor([one + half_ulp, -(one + half_ulp), one + half_ulp / 2,
                      3.0, 1e-30, 0.0])
    assert tf32(v).tolist() == pytest.approx(
        [one + 2 * half_ulp, -(one + 2 * half_ulp), one, 3.0,
         tf32(torch.tensor([1e-30])).item(), 0.0])
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    hi = tf32(r)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    lo = tf32(r - hi)
    assert ((hi + lo - r).abs() <= r.abs() * 2.0 ** -21).all()
    bf = r.bfloat16().float()
    assert torch.equal(tf32(bf), bf)        # bf16 values are exact in TF32


def _constants():
    """The source and its namespace-scope ``constexpr int`` constants, each
    evaluated from its integer expression over the constants before it."""
    src = (SK.CSRC / "ssd.cu").read_text()
    const: dict = {}
    for name, expr in re.findall(
            r"^constexpr int (\w+) = ([\w\s*+/]+);", src, re.M):
        const[name] = eval(expr.replace("/", "//"), {"__builtins__": {}},
                           dict(const))
    return src, const


def test_tile_constants_match_the_cuda_source():
    """kernel.py's mirrors (MAX_*, THREADS, the mma and wgmma tiles,
    AUX_ROWS, KERNELS) are the constants and kernels of csrc/ssd.cu."""
    src, const = _constants()
    assert (SK.MAX_CHUNK, SK.MAX_STATE, SK.MAX_HEAD_DIM) == (
        const["QM"], const["NM"], const["PM"])
    assert SK.THREADS == const["NT"]
    assert SK.AUX_ROWS == const["AUX"]
    assert "mma.sync.aligned.m{}n{}k{}.row.col.f32.tf32.tf32.f32".format(
        *SK.MMA_TILE) in src
    assert "wgmma.mma_async.sync.aligned.m{}n{}k{}.f32.tf32.tf32".format(
        *SK.WGMMA_TILE) in src
    # a warpgroup's 64 rows, the head dim as the product's width, k-steps
    # of 8 over the chunk; the chunk's rows are two warpgroups
    assert SK.WGMMA_TILE == (64, SK.MAX_HEAD_DIM, 8)
    assert const["KSTEPS"] * SK.WGMMA_TILE[2] == SK.MAX_CHUNK
    assert SK.THREADS == 128 * (SK.MAX_CHUNK // SK.WGMMA_TILE[0])
    launched = re.findall(r"(ssd_\w+)(?:<[\w:]+>)?<<<", src)
    assert tuple(dict.fromkeys(launched)) == SK.KERNELS
    assert not re.search(r"\batomic\w*\s*\(", src)   # sums in fixed order


def test_interface_matches_the_cuda_source():
    """kernel.ABI is the source's ssd_abi(); _bind declares as many
    arguments as the source's ssd_launch and ssd_smem_bytes take; and
    ssd_smem_bytes numbers the kernels as KERNELS orders them (1 the
    chunk-state kernel, 3 the output kernel, the two with dynamic shared
    memory)."""
    import types
    src, _ = _constants()
    assert int(re.search(r"int ssd_abi\(\) \{ return (\d+); \}",
                         src)[1]) == SK.ABI
    fns = {name: types.SimpleNamespace() for name in
           ("ssd_launch", "ssd_abi", "ssd_smem_bytes")}
    SK._bind(types.SimpleNamespace(**fns))
    for name, fn in fns.items():
        params = re.search(rf"^int {name}\(([^)]*)\)", src, re.M)[1]
        assert len(fn.argtypes) == len([p for p in params.split(",")
                                        if p.strip()]), name
    cases = dict(re.findall(r"case (\d):\s+return bf \? (\w+)<", src))
    assert SK.KERNELS[int(next(k for k, v in cases.items()
                               if v == "state_smem"))] == "ssd_chunk_state"
    assert SK.KERNELS[int(next(k for k, v in cases.items()
                               if v == "out_smem"))] == "ssd_chunk_out"
    for kname, smem in (("ssd_chunk_state", "state_smem"),
                        ("ssd_chunk_out", "out_smem")):
        assert f"{kname}<T><<<chunks, NT, {smem}<T>(), stream>>>" in src


def _ptxas_log(spill_in=None, leave_out=None):
    """A build log of the SSD library as ptxas -v writes it: every kernel
    instantiation of csrc/ssd.cu, one of them spilling if asked, one left
    out if asked."""
    ns = "_ZN38_GLOBAL__N__fb79325f_6_ssd_cu_7e9368b4"
    names = [f"{ns}8ssd_prepENS_4ArgsE", f"{ns}14ssd_state_passENS_4ArgsE"
             ] + [f"{ns}{len(k)}{k}I{t}EEvNS_4ArgsE"
                  for k in ("ssd_chunk_state", "ssd_chunk_out")
                  for t in ("13__nv_bfloat16", "f")]
    log = ""
    for n in names:
        if leave_out and leave_out in n:
            continue
        spill = 8 if spill_in and spill_in in n else 0
        log += (f"ptxas info    : Compiling entry function '{n}' for "
                f"'sm_90a'\nptxas info    : Function properties for {n}\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, "
                f"{spill} bytes spill loads\nptxas info    : Used 128 "
                f"registers, used 1 barriers, 0 bytes smem\n")
    return log


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py's phases object (its build report reads no card)."""
    import importlib.util
    root = SK.CSRC.parents[4]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.Smoke(torch)


class _Library:
    """What the build report asks of the library: each kernel's dynamic
    shared memory (here 1000 x its place + 1 for bf16 B/C)."""

    @staticmethod
    def ssd_smem_bytes(k, bc_dtype):
        return 1000 * k + bc_dtype


def test_build_report_names_every_ssd_kernel(smoke, capsys):
    """chip_smoke.py's build phase reports each SSD kernel instantiation's
    registers, spills and shared memory (the dynamic bytes from the
    library's ssd_smem_bytes, by kernel and B/C dtype)."""
    smoke.ssd_build_report({"ssd": (_Library(), _ptxas_log())})
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6
    for kname in SK.KERNELS:
        assert any(f"ssd: {kname}<" in line for line in lines)
    assert any("ssd_chunk_out<__nv_bfloat16>" in line and
               "and 3,001 of dynamic" in line for line in lines)
    assert any("ssd_chunk_state<float>" in line and
               "and 1,000 of dynamic" in line for line in lines)


@pytest.mark.parametrize("fault", ["spill", "missing"])
def test_build_report_fails_on_a_spill_or_a_missing_kernel(smoke, fault):
    log = _ptxas_log(spill_in="ssd_chunk_outIf") if fault == "spill" else \
        _ptxas_log(leave_out="ssd_state_pass")
    with pytest.raises(SystemExit, match="spills|no ptxas report"):
        smoke.ssd_build_report({"ssd": (_Library(), log)})


@pytest.mark.parametrize("case", ["aligned", "P 6", "x rows off 16 bytes",
                                  "B rows off 16 bytes", "C not unit"])
def test_kernels_take_rows_on_16_byte_boundaries(case):
    """The CUDA path's refusals beyond the plain version's: the kernels
    read x, B and C in 16-byte pieces (checked on CPU tensors here, where
    the wrapper itself runs the plain version)."""
    x = torch.zeros(2, 8, 3, 8).transpose(1, 2)          # [B, H, S, P] view
    bm = cm = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    if case == "P 6":
        x = torch.zeros(2, 8, 3, 6).transpose(1, 2)
    elif case == "x rows off 16 bytes":
        x = torch.zeros(2, 8, 3, 9)[..., 1:].transpose(1, 2)
    elif case == "B rows off 16 bytes":
        bm = torch.zeros(2, 8, 20, dtype=torch.bfloat16)[..., 4:]
    elif case == "C not unit":
        cm = torch.zeros(2, 16, 8, dtype=torch.bfloat16).transpose(1, 2)
    if case == "aligned":
        SK._check_rows(x, bm, cm)
    else:
        with pytest.raises(ValueError):
            SK._check_rows(x, bm, cm)


@pytest.mark.parametrize("tag", [None, "shipped", 7])
def test_against_takes_the_interface_its_tag_names(smoke, tag):
    """``chip_smoke.py --against``: a library with no ssd_abi() is called
    through the first SSD port's ssd_launch (9 arguments), one whose tag is
    kernel.ABI through the wrapper, and one with any other tag is refused
    before anything is called."""
    import types
    lib = types.SimpleNamespace(ssd_launch=types.SimpleNamespace(),
                                ssd_smem_bytes=types.SimpleNamespace())
    if tag is not None:
        abi = SK.ABI if tag == "shipped" else tag
        lib.ssd_abi = lambda: abi
    x = torch.zeros(2, 256, 3, 8).transpose(1, 2)
    a = torch.zeros(2, 256, 3).transpose(1, 2)
    bm = cm = torch.zeros(2, 256, 16, dtype=torch.bfloat16)
    if tag == 7:
        with pytest.raises(SystemExit, match="ssd_abi"):
            smoke.ssd_against_call(lib, x, a, bm, cm)
        return
    call = smoke.ssd_against_call(lib, x, a, bm, cm)
    assert callable(call)
    assert len(lib.ssd_launch.argtypes) == (9 if tag is None else 12)
