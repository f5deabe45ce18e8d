#!/usr/bin/env python3
"""Variants of a hand-written kernel, timed beside the shipped source on one
CUDA card: what bounds the bf16 flash attention forward or the SSD scan.

Builds copies of the kernel's ``csrc`` (under the git-ignored
``build/chip_variants/<kernel>``), each with one change to its main source
(every ``nvcc`` started together), prints each copy's ptxas report
(registers, spills), and times each in turns with the shipped kernel
(shipped, variant, variant, shipped; device ms a launch from CUDA events,
as ``chip_smoke.py`` *timing* takes them) with the SM clock and power draw
sampled meanwhile.  A variant whose change no longer applies to the source
stops the run before anything is built.  Run from the repository root:

    python3 chip_variants.py flash [--against DIR]
    python3 chip_variants.py ssd
    python3 chip_variants.py tp_repeat [N] [ARCH]
    python3 chip_variants.py alias_race [N]

``flash`` (``csrc/flash_fwd.cu``) has four variants that compute the same
function:

* ``no_turns``: the named barriers that make the two consumer warpgroups
  take turns on the tensor cores are gone; each issues its products when
  its tiles have landed;
* ``no_overlap``: a consumer waits for o += p v of its previous tile
  before its exponentials (no overlap within a warpgroup);
* ``stages2``: a ring of 2 stages instead of 3;
* ``mask_all``: the element mask runs on every tile, not only on those
  that straddle the diagonal or the window's edge;

and two that compute something else, timed only:

* ``no_loads``: the producer loads the first 3 stages and then only
  signals each stage as loaded, so the consumers reread stale tiles;
* ``no_exp``: each p is the fused multiply-add without its ex2.

``--against DIR`` adds the forward built from another ``csrc`` directory
(a parent commit's, unpacked into a git-ignored directory) as one more
variant.  The shipped kernel's SASS (``cuobjdump``) goes to
``build/chip_variants/flash/flash_fwd_bf16_128.sass`` with its opcodes
counted; each variant but the two timing-only ones is held against the
plain version at danube's heads (32/8, D 120, S 4,096, window 1,024, bf16)
to ``chip_smoke.py``'s tolerances; all are timed at the training shape (B
2, S 4,096, causal) and the prefill shape (B 1, S 32,768, window 8,192).

``ssd`` (``csrc/ssd.cu``) has variants that each take one part of the work
out, timed only at mamba2's prefill shape (B 8, 24 heads, S 32,768, P 64,
N 128, chunk 128, bf16 B/C), each with its kernels' shares of a call from
the profiler:

* ``no_wgmma``: the per-head wgmma products are not issued (their A
  fragments are still built);
* ``one_pass``: one TF32 pass per product instead of the split's two or
  three;
* ``no_planes``: landed tiles are not turned into TF32 planes;
* ``no_loads``: after the first tiles nothing more is loaded;
* ``no_mgen``: the output kernel's G * L fragments skip their exponentials
  and masks;

then the card's ``mma.sync`` m16n8k8 TF32 and m16n8k16 bf16 rates (a loop
of independent accumulators, 8 blocks an SM), TFLOP/s.

``tp_repeat [N] [ARCH]`` is no kernel variant: it repeats
``chip_smoke.py``'s tensor-parallel step check of granite (or ARCH:
``minicpm3_4b``, ``mamba2_130m``; ``tp_family_train``: grad_sync xla and
ring against one device) N times (default 20) in one process, after
danube's ``tp_train`` and ``tp_prefill`` as the full run orders them, and
prints each repeat's worst gradient per mode, its peak memory and the
memory left allocated before it (a failed check is printed and the
repeat goes on; a step whose worst gradient passes 1e-5 also prints its
worst leaves and each router's error by model rank).  ``alias_race [N]``
runs the fault of the cross-rank copy that ``spmd._Copy`` replaced alone
N times (default 200), with that plain copy and the shipped one
(``run_alias_race``): the card's guard against that fault's return.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent
KSRC = ROOT / "src/repro_torch/kernels"
OUT = ROOT / "build/chip_variants"


def _replace(*pairs: tuple[str, str]) -> Callable[[str], str]:
    """A variant made of exact replacements; it leaves the text as it was
    (and so does not apply) unless every ``old`` is in it."""
    def patch(text: str) -> str:
        if not all(old in text for old, _ in pairs):
            return text
        for old, new in pairs:
            text = text.replace(old, new)
        return text
    return patch


# ------------------------------------------------------------------ flash
def _no_turns(text: str) -> str:
    lines = [ln for ln in text.split("\n")
             if "hopper::bar_sync(mine" not in ln
             and "hopper::bar_arrive(other" not in ln]
    return "\n".join(lines)


OVERLAP = """\
      issue_scores<DP>(sc, dq, dk0 + s * STEP);
      hopper::wgmma_commit();
      // o += p v of the previous tile runs on the tensor cores while this
      // tile's exponentials run
      issue_pv<DP>(o, pa, dv0 + sp * STEP);
      hopper::wgmma_commit();
      hopper::bar_arrive(other, 256);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      hopper::mbar_arrive(empty_k + s);       // k of tile i is read
      softmax_tile(a, ra, k0, t, sl2, lim, sc, m, l, c);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      hopper::mbar_arrive(empty_v + sp);      // v of tile i - 1 is read
"""
NO_OVERLAP = """\
      issue_pv<DP>(o, pa, dv0 + sp * STEP);
      issue_scores<DP>(sc, dq, dk0 + s * STEP);
      hopper::wgmma_commit();
      hopper::bar_arrive(other, 256);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      hopper::mbar_arrive(empty_k + s);       // k of tile i and v of tile
      hopper::mbar_arrive(empty_v + sp);      // i - 1 are read
      softmax_tile(a, ra, k0, t, sl2, lim, sc, m, l, c);
"""
FLASH_VARIANTS = {
    "no_turns": _no_turns,
    "no_overlap": _replace((OVERLAP, NO_OVERLAP)),
    "stages2": _replace(("constexpr int STAGES = 3;",
                         "constexpr int STAGES = 2;")),
    "mask_all": _replace(("k0 + FWD_KEYS - 1) ==\n      ALL)",
                          "k0 + FWD_KEYS - 1) ==\n      -1)")),
    "no_loads": _replace((
        "          hopper::mbar_expect_tx(f, L::TILE);",
        "          if (i >= STAGES) {\n            hopper::mbar_arrive(f);\n"
        "            continue;\n          }\n"
        "          hopper::mbar_expect_tx(f, L::TILE);")),
    "no_exp": _replace((
        "float p = hopper::ex2(__fmaf_rn(sc[x], sl2, nm[i]));",
        "float p = __fmaf_rn(sc[x], sl2, nm[i]);")),
}
FLASH_UNCHECKED = ("no_loads", "no_exp")   # their output is not the function

# -------------------------------------------------------------------- ssd
PRODUCTS = """\
    if (!AEXACT) wgmma_tf32(d, al[s], plane_desc(bh, ks0 + s));
    wgmma_tf32(d, ah[s], plane_desc(bl, ks0 + s));
    wgmma_tf32(d, ah[s], plane_desc(bh, ks0 + s));
"""
MGEN = """\
              m[0] = j0 <= i0 ? gr[0] * ex2(ci0 - cj0) : 0.f;
              m[1] = gr[8 * gld] * ex2(ci1 - cj0);
              m[2] = j1 <= i0 ? gr[4] * ex2(ci0 - cj1) : 0.f;
              m[3] = j1 <= i1 ? gr[8 * gld + 4] * ex2(ci1 - cj1) : 0.f;
"""
SSD_VARIANTS = {
    "no_wgmma": _replace((PRODUCTS, "")),
    "one_pass": _replace((PRODUCTS, "    wgmma_tf32(d, ah[s], plane_desc("
                                    "bh, ks0 + s));\n")),
    "no_planes": _replace(
        ("    if (odd || c > 0) to_planes(slot, nullptr, planes);",
         "    if (c < 0) to_planes(slot, nullptr, planes);"),
        ("    to_planes(slot, slot + QM * LDX, planes);",
         "    if (c < 0) to_planes(slot, slot + QM * LDX, planes);")),
    "no_loads": _replace(
        ("    if (item < items) {\n      float* slot",
         "    if (item < 2) {\n      float* slot"),
        ("    if (h < a.H) {\n      float* slot",
         "    if (h < 2) {\n      float* slot")),
    "no_mgen": _replace((MGEN, "              m[0] = gr[0];\n"
                               "              m[1] = gr[8 * gld];\n"
                               "              m[2] = cj0;\n"
                               "              m[3] = cj1;\n")),
}

MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int K>
__global__ void bench(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (K == 8)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// TFLOP/s of mma.sync m16n8k8 TF32 (k 8) or m16n8k16 bf16 (k 16)
extern "C" float mma_rate(int k, int sms, int iters) {
  float* out;
  if (cudaMalloc(&out, sms * 8 * 256 * sizeof(float))) return -1.f;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = 0.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (k == 8) bench<8><<<sms * 8, 256>>>(out, iters);
    else bench<16><<<sms * 8, 256>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaFree(out);
  const double flops = 2.0 * 16 * 8 * k * 8 * (double)iters * sms * 8 * 256
                       / 32;
  return static_cast<float>(flops / (ms * 1e-3) / 1e12);
}
"""

# kernel: (csrc directory, main source, its variants, ptxas entries shown)
KERNELS = {
    "flash": (KSRC / "flash_attention/csrc", "flash_fwd.cu", FLASH_VARIANTS,
              "bf16"),
    "ssd": (KSRC / "ssd/csrc", "ssd.cu", SSD_VARIANTS, "ssd_"),
}


def variant_sources(kernel: str) -> dict[str, str]:
    """The main source of every variant of ``kernel``; exits if one of them
    does not change the shipped source (its change no longer applies)."""
    csrc, main, variants, _ = KERNELS[kernel]
    text = (csrc / main).read_text()
    sources = {name: patch(text) for name, patch in variants.items()}
    same = [name for name, t in sources.items() if t == text]
    if same:
        raise SystemExit(f"chip_variants: {kernel} variants {same} do not "
                         f"apply to {main}")
    return sources


def build(kernel: str, sources: dict, against: Path | None = None,
          extra: dict | None = None) -> dict:
    """Compile every variant of ``kernel`` (``sources``: name -> main
    source; each built beside a copy of the rest of its csrc), the csrc in
    ``against`` as one more, and ``extra`` (name -> a source of its own),
    all in parallel; print each variant's ptxas report and load each."""
    from repro_torch.kernels import _build
    csrc, main, _, shown = KERNELS[kernel]
    jobs = {}
    # (name, its main source or None to build the copy as it is, the csrc
    # copied beside it, the file compiled)
    todo = [(name, text, csrc, main) for name, text in sources.items()]
    if against:
        todo.append(("against", None, against, main))
    todo += [(name, text, None, f"{name}.cu")
             for name, text in (extra or {}).items()]
    for name, text, src, file in todo:
        d = OUT / kernel / name
        d.mkdir(parents=True, exist_ok=True)
        for f in (src.glob("*.cu*") if src else ()):
            shutil.copy(f, d / f.name)
        if text is not None:
            (d / file).write_text(text)
        so = d / "lib.so"
        jobs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(d / file)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            for other, _ in jobs.values():
                other.kill()
            raise SystemExit(f"chip_variants: nvcc failed on {name}:\n{log}")
        for entry, e in _build.ptxas_entries(log).items():
            if shown in entry:
                print(f"[build] {name}: {entry}: {e['registers']} registers,"
                      f" {e['spill_stores']} / {e['spill_loads']} bytes of "
                      "spill stores / loads", flush=True)
        for line in log.splitlines():
            if "C75" in line:           # ptxas's wgmma serialization notes
                print(f"[build] {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


@contextlib.contextmanager
def clocks(name: str):
    """Sample the SM clock and power draw while the block runs; print
    min / median / max after it."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
    try:
        yield
    finally:
        smi.terminate()
        samples = [tuple(float(x) for x in line.split(","))
                   for line in smi.communicate()[0].splitlines()
                   if line.count(",") == 1]
    if samples:
        mhz = sorted(x[0] for x in samples)
        watts = sorted(x[1] for x in samples)
        print(f"[clocks] {len(samples)} samples while timing: SM clock "
              f"{mhz[0]:.0f} / {mhz[len(mhz) // 2]:.0f} / {mhz[-1]:.0f} MHz,"
              f" power draw {watts[0]:.1f} / {watts[len(watts) // 2]:.1f} / "
              f"{watts[-1]:.1f} W (min / median / max); card {name}",
              flush=True)


def in_turns(ms, shipped, lib) -> list[float]:
    """Device ms of ``ms(shipped)``, ``ms(lib)``, ``ms(lib)``,
    ``ms(shipped)``, in that order."""
    return [ms(shipped), ms(lib), ms(lib), ms(shipped)]


def sass_report(so: Path) -> None:
    """Write the SASS of flash_fwd_bf16<128> in library ``so`` under OUT
    and print its opcode counts, most frequent first."""
    cuobjdump = Path(shutil.which("cuobjdump") or
                     "/usr/local/cuda/bin/cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    blocks = re.split(r"\n\s+Function : ", text)
    body = next((b for b in blocks if b.startswith("_Z") and
                 "flash_fwd_bf16ILi128E" in b.split("\n", 1)[0]), "")
    (OUT / "flash").mkdir(parents=True, exist_ok=True)
    (OUT / "flash" / "flash_fwd_bf16_128.sass").write_text(body)
    ops = collections.Counter(
        m.group(1).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
            body))
    print(f"[sass] flash_fwd_bf16<128>: {sum(ops.values())} instructions: "
          + ", ".join(f"{k} {v}" for k, v in ops.most_common(40)),
          flush=True)


def run_flash(torch, cs, against: Path | None) -> bool:
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as Fa
    smoke = cs.Smoke(torch)
    shipped = Fa.build()[0]
    sass_report(Path(shipped._name))
    libs = build("flash", variant_sources("flash"), against)
    for lib in libs.values():
        # the launch is all that flash_fwd calls (an older library may
        # lack the rest)
        lib.flash_fwd_launch.argtypes = shipped.flash_fwd_launch.argtypes
        lib.flash_fwd_launch.restype = ctypes.c_int
    name_card = card()
    print(name_card, flush=True)

    def use(lib):
        _build._loaded["flash_fwd"] = lib

    ok = True
    q, k, v = smoke.attn_inputs(1, 32, 8, 4096, 120, "bfloat16")
    flat = [x.transpose(1, 2).reshape(-1, 4096, 120).contiguous()
            for x in (q, k, v)]
    o_ref, l_ref = Fa.attention_ref(*(x.float() for x in flat), window=1024)
    for name, lib in libs.items():
        if name in FLASH_UNCHECKED:
            continue
        use(lib)
        o, lse = Fa.flash_fwd(*flat, window=1024)
        torch.cuda.synchronize()
        good, _, msg = smoke.attn_close(o, lse, o_ref, l_ref,
                                        *cs.FLASH_TOL["bfloat16"])
        ok &= good
        print(f"[check] {name}: {msg} {'ok' if good else 'FAILED'}",
              flush=True)
    del q, k, v, flat, o_ref, l_ref
    with clocks(name_card):
        for shape, B, S, w in (("B=2 S=4096 causal", 2, 4096, 8192),
                               ("B=1 S=32768 window 8192", 1, 32768, 8192)):
            q, k, v = smoke.attn_inputs(B, 32, 8, S, 120, "bfloat16")
            views = [x.transpose(1, 2) for x in (q, k, v)]
            n = 30 if S == 4096 else 10

            def ms(lib):
                use(lib)
                return cs.timed(lambda: Fa.flash_fwd(*views, window=w), n,
                                torch)[0]

            if S == 4096:
                print(f"[timing] {shape}: one causal "
                      f"scaled_dot_product_attention "
                      f"{smoke.sdpa_ms(q, k, v, 0):.4f} ms; card "
                      f"{name_card}", flush=True)
            for name, lib in libs.items():
                t = in_turns(ms, shipped, lib)
                print(f"[timing] {shape}: shipped {t[0]:.4f} / {t[3]:.4f} "
                      f"ms, {name} {t[1]:.4f} / {t[2]:.4f} ms: {name} takes "
                      f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}x; card "
                      f"{name_card}", flush=True)
            del q, k, v, views
    use(shipped)
    print("chip_variants: " + (
        "all flash variants agree with the plain version" if ok
        else "a flash variant FAILED its check"), flush=True)
    return ok


def run_ssd(torch, cs) -> bool:
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd as Sd
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    SK = Sd.kernel
    shipped = SK.build()[0]
    libs = build("ssd", variant_sources("ssd"),
                 extra={"mma_bench": MMA_BENCH})
    bench = libs.pop("mma_bench")
    bench.mma_rate.restype = ctypes.c_float
    for lib in libs.values():
        SK._bind(lib)
    name_card = card()
    print(name_card, flush=True)
    B, S, H, P, N, Q = cs.SSD_MAIN
    x, a, Bm, Cm = cs.Smoke(torch).ssd_case(B, S, H, P, N, "bfloat16")
    xv, av = x.transpose(1, 2), a.transpose(1, 2)

    def use(lib):
        _build._loaded["ssd"] = lib

    def call():
        Sd.ssd_chunked(xv, av, Bm, Cm, chunk=Q, n_heads=H)

    def ms(lib):
        use(lib)
        return cs.timed(call, 5, torch)[0]

    def shares(lib) -> str:
        use(lib)
        call()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                call()
            torch.cuda.synchronize()
        per: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                k = next((k for k in SK.KERNELS if f"::{k}" in e.name),
                         e.name[:30])
                per[k] = per.get(k, 0.0) + e.time_range.elapsed_us() / 2e3
        return ", ".join(f"{k} {v:.3f}" for k, v in per.items())

    print(f"[timing] shipped: {shares(shipped)} ms", flush=True)
    with clocks(name_card):
        for name, lib in libs.items():
            t = in_turns(ms, shipped, lib)
            print(f"[timing] {name}: {t[1]:.4f} / {t[2]:.4f} ms a call "
                  f"against the shipped {t[0]:.4f} / {t[3]:.4f} "
                  f"({(t[1] + t[2]) / (t[0] + t[3]):.3f}x); {shares(lib)} "
                  f"ms; card {name_card}", flush=True)
    use(shipped)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k, what in ((8, "mma.sync m16n8k8 TF32"),
                    (16, "mma.sync m16n8k16 bf16")):
        print(f"[mma] {what}: {bench.mma_rate(k, sms, 4000):.1f} TFLOP/s "
              f"({sms} SMs, 8 blocks of 8 warps an SM, 8 independent "
              f"accumulators a warp), card {name_card}", flush=True)
    return True


READING = re.compile(r"grad_sync (\w+)\W.*?worst gradient \(?([0-9.e+-]+|inf)"
                     r"(?: rel L2 \(|, ')([\w.]+)")
PEAK = re.compile(r"peak memory ([0-9.]+) GiB")


@contextlib.contextmanager
def _patched(obj, name: str, value):
    """Within: ``obj.name`` is ``value``."""
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


class _PlainCopy:
    """The cross-rank copy that ``spmd._Copy`` replaced: ``Tensor.to``,
    whose backward hands every sender the receiver's gradient itself."""

    @staticmethod
    def apply(x, dev):
        return x.to(dev, copy=True, non_blocking=dev.type == "cuda")


def _leaf_log(cs, names: list, experts: int, tp: int):
    """``chip_smoke.finite_rel`` made to log each call: yields a function
    that prints, for a step whose worst gradient passed 1e-5, its four
    worst leaves and each router's error per model rank's block of
    experts (tp_family_train takes each leaf's gradient error in
    parameter order, then each update's)."""
    real, calls = cs.finite_rel, []

    def logged(torch, a, b):
        r = real(torch, a, b)
        blocks = None
        if a.ndim == 2 and a.shape[-1] == experts:
            blocks = [real(torch, x, y) for x, y in
                      zip(a.chunk(tp, -1), b.chunk(tp, -1))]
        calls.append((r, blocks))
        return r

    def report(i):
        n = len(names)
        for m, mode in enumerate(("xla", "ring")):
            grads = calls[2 * n * m: 2 * n * m + n]
            if len(grads) < n or max(r for r, _ in grads) <= 1e-5:
                continue
            worst = sorted(zip(grads, names), key=lambda x: -x[0][0])[:4]
            print(f"[tp_repeat] repeat {i} {mode}: worst leaves "
                  + ", ".join(f"{k} {r:.3g}" for (r, _), k in worst)
                  + "; routers by model rank's block: "
                  + ", ".join(f"{k} {[float(f'{x:.3g}') for x in b]}"
                              for (r, b), k in zip(grads, names) if b),
                  flush=True)
        calls.clear()

    cs.finite_rel = logged
    return report


def run_tp_repeat(torch, cs, repeats: int, arch: str) -> bool:
    """``arch``'s tensor-parallel step check (``chip_smoke.py``
    ``tp_family_train``: grad_sync xla, then ring, each against one
    device) ``repeats`` times in one process, after danube's ``tp_train``
    and ``tp_prefill`` as the full run orders them.  A failed check is
    printed and the repeat goes on.  One line a repeat: each mode's worst
    gradient and its leaf, the step's peak memory, and the memory
    allocated before the repeat, before and after a garbage collection;
    for a mode whose worst gradient passed 1e-5, its worst leaves and the
    routers' error by model rank."""
    import dataclasses
    import gc
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import make_model
    smoke = cs.Smoke(torch)
    smoke.build()
    cfg = dataclasses.replace(registry.get_config(arch),
                              num_layers=cs.DP_LAYERS)
    dp, tp = cs.TP_MESH
    names = [k for k, _ in make_model(
        cfg, device="meta", mesh=make_mesh(cs.TP_MESH, ("data", "model"),
                                           ["meta"] * (dp * tp)))
        .named_parameters()]
    report = _leaf_log(cs, names, cfg.moe.num_experts if cfg.moe else -1,
                       tp)
    heard, say, fail = [], cs.say, cs.fail

    def hearing(phase, msg):
        heard.append(msg)
        say(phase, msg)

    def failing(phase, msg):
        print(f"[{phase}] FAILED (the repeat goes on): {msg}", flush=True)

    cs.say, cs.fail = hearing, failing
    rows = []
    smoke.tp_train()
    smoke.tp_prefill()
    for i in range(repeats):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        found = gc.collect()
        after = torch.cuda.memory_allocated()
        heard.clear()
        t0 = time.time()
        try:
            smoke.tp_family_train(arch)
        except Exception as e:  # noqa: BLE001 - a reading
            print(f"[tp_repeat] repeat {i}: {type(e).__name__}: {e}",
                  flush=True)
        report(i)
        got = []
        for msg in heard:
            m, p = READING.search(msg), PEAK.search(msg)
            if m:
                got.append((m[1], float(m[2]), m[3], p[1] if p else "?"))
        rows.append(got)
        print(f"[tp_repeat] repeat {i}: " + ("; ".join(
            f"{mo} {v:.3g} ({k}, peak {pk} GiB)" for mo, v, k, pk in got)
            or "no reading")
            + f"; allocated before {before / 2**30:.3f} GiB, after a garbage"
            f" collection ({found} objects) {after / 2**30:.3f} GiB; "
            f"{time.time() - t0:.1f} s", flush=True)
    cs.say, cs.fail = say, fail
    bad = sum(v > cs.TP_GRAD_REL_L2 for got in rows for _, v, _, _ in got)
    missing = sum(2 - len(got) for got in rows)
    print(f"[tp_repeat] {arch}, {repeats} repeats: {bad} readings past "
          f"{cs.TP_GRAD_REL_L2}, {missing} missing; card {card()}",
          flush=True)
    return bad == 0 and missing == 0


def main(argv) -> int:
    against = None
    if argv[:1] == ["tp_repeat"]:
        return tp_repeat_main(argv[1:])
    if argv[:1] == ["alias_race"] and (len(argv) == 1 or argv[1].isdigit()):
        import torch
        if not torch.cuda.is_available():
            print("chip_variants: no CUDA device", file=sys.stderr)
            return 2
        sys.path.insert(0, str(ROOT / "src"))
        torch.backends.cuda.matmul.allow_tf32 = False
        return 0 if run_alias_race(
            torch, int(argv[1]) if len(argv) > 1 else 200) else 1
    if argv[:1] == ["flash"] and argv[1:2] == ["--against"] and \
            len(argv) == 3:
        against = Path(argv[2]).resolve()
    elif argv not in (["flash"], ["ssd"]):
        print("usage: chip_variants.py flash [--against CSRC_DIR] | ssd | "
              "tp_repeat [N] [ARCH] | alias_race [N]",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    ok = (run_flash(torch, cs, against) if argv[0] == "flash"
          else run_ssd(torch, cs))
    return 0 if ok else 1


def run_alias_race(torch, trials: int) -> bool:
    """The pattern of the MoE aux loss alone, ``trials`` times with the
    cross-rank copy that ``spmd._Copy`` replaced (``_PlainCopy``) and with the
    shipped one: on (data 2, model 4) over the card, rank r sums ``a @
    w_r`` (a scalar, as a rank's aux loss is) and ``pmean``s it over every
    rank; one backward from ranks 0 and 4 (the two data ranks' model-0
    ranks, as the loss's two data ranks) gives every ``w_r`` its gradient
    ``a.sum(0)`` / 4 broadcast.  Before the backward the odd ranks'
    streams are given ``busy`` matrix products, so that their gradient
    sums queue behind them while the even ranks' run at once.  Prints the
    trials whose gradients part from the exact value by more than 1e-4 of
    it, for each copy."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import spmd
    from repro_torch.parallel.spmd import P
    dev = torch.device("cuda")
    mesh = make_mesh((2, 4), ("data", "model"), [dev] * 8)
    gen = torch.Generator(device=dev).manual_seed(0)
    N, busy = 2048, 8
    a = torch.randn(N, N, device=dev, generator=gen)
    want = (a.sum(0)[:, None] / 4).expand(N, N)
    ok = True
    for name, copy in (("plain copy (before the fix)", _PlainCopy),
                       ("shipped copy", spmd._Copy)):
        bad, worst = 0, 0.0
        with _patched(spmd, "_Copy", copy):
            for _ in range(trials):
                ws = [torch.ones(N, N, device=dev, requires_grad=True)
                      for _ in range(8)]
                outs = [None] * 8

                def f(_, ws=ws, outs=outs):
                    r = spmd.rank_index()
                    outs[r] = spmd.pmean((a @ ws[r]).sum(),
                                         ("data", "model"))
                    return outs[r].detach()

                spmd.shard_map(f, mesh=mesh, in_specs=P(),
                               out_specs=P())(a[:1, :1])
                for r in range(1, 8, 2):
                    with torch.no_grad(), torch.cuda.stream(
                            spmd._rank_stream(r, dev)):
                        for _ in range(busy):
                            a @ a
                gs = torch.autograd.grad(outs[0] + outs[4], ws)
                torch.cuda.synchronize()
                err = max(float((g - want).abs().max() / want.abs().max())
                          for g in gs)
                worst = max(worst, err)
                bad += err > 1e-4
        print(f"[alias_race] {name}: {bad} of {trials} trials with a "
              f"gradient off by more than 1e-4, worst {worst:.3g}; card "
              f"{card()}", flush=True)
        ok = ok and (bad == 0 or copy is _PlainCopy)
    return ok


TP_REPEAT_ARCHS = ("granite_moe_1b_a400m", "minicpm3_4b", "mamba2_130m")


def tp_repeat_main(argv) -> int:
    arch = next((a for a in argv if a in TP_REPEAT_ARCHS), TP_REPEAT_ARCHS[0])
    rest = [a for a in argv if a != arch]
    if len(rest) > 1 or (rest and not rest[0].isdigit()):
        print(f"usage: chip_variants.py tp_repeat [N] [ARCH]; ARCH one of "
              f"{TP_REPEAT_ARCHS}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return 0 if run_tp_repeat(torch, cs, int(rest[0]) if rest else 20,
                              arch) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
