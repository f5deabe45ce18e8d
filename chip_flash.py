#!/usr/bin/env python3
"""Variants of the bf16 flash attention forward, timed beside the shipped
kernel on one CUDA card.

Builds copies of ``src/repro_torch/kernels/flash_attention/csrc`` (under the
git-ignored ``build/chip_flash``), each with one change to ``flash_fwd.cu``:

* ``no_turns``: the named barriers that make the two consumer warpgroups
  take turns on the tensor cores are gone; each issues its products when
  its tiles have landed;
* ``no_overlap``: a consumer waits for o += p v of its previous tile
  before its exponentials (no overlap within a warpgroup);
* ``stages2``: a ring of 2 stages instead of 3;
* ``mask_all``: the element mask runs on every tile, not only on those
  that straddle the diagonal or the window's edge;

and two that compute something else, timed only, to see what bounds the
shipped kernel:

* ``no_loads``: the producer loads the first 3 stages and then only
  signals each stage as loaded, so the consumers reread stale tiles and
  nothing more comes from L2 or device memory;
* ``no_exp``: each p is the fused multiply-add without its ex2.

``--against DIR`` adds the forward built from another ``csrc`` directory
(a parent commit's, unpacked into a git-ignored directory) as one more
variant.  First the shipped kernel's SASS (``cuobjdump``) goes to
``build/chip_flash/flash_fwd_bf16_128.sass`` and its opcodes are counted;
then each variant's ptxas report (registers, spills) is printed, each but
the two timing-only ones is held against the plain version at danube's
heads (32/8, D 120, S 4,096, window 1,024, bf16) to ``chip_smoke.py``'s
tolerances, and all are timed against the shipped kernel in turns
(shipped, variant, variant, shipped; device ms a launch from CUDA events,
as ``chip_smoke.py`` *timing* takes them) at the training shape (B 2, S
4,096, causal) and the prefill shape (B 1, S 32,768, window 8,192), with
the SM clock and power sampled meanwhile.  Run from the repository root:

    python3 chip_flash.py [--against DIR]
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"
OUT = ROOT / "build/chip_flash"


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

VARIANTS = {
    "no_turns": _no_turns,
    "no_overlap": lambda t: t.replace(OVERLAP, NO_OVERLAP),
    "stages2": lambda t: t.replace("constexpr int STAGES = 3;",
                                   "constexpr int STAGES = 2;"),
    "mask_all": lambda t: t.replace("k0 + FWD_KEYS - 1) ==\n      ALL)",
                                    "k0 + FWD_KEYS - 1) ==\n      -1)"),
    "no_loads": lambda t: t.replace(
        "          hopper::mbar_expect_tx(f, L::TILE);",
        "          if (i >= STAGES) {\n            hopper::mbar_arrive(f);\n"
        "            continue;\n          }\n"
        "          hopper::mbar_expect_tx(f, L::TILE);"),
    "no_exp": lambda t: t.replace(
        "float p = hopper::ex2(__fmaf_rn(sc[x], sl2, nm[i]));",
        "float p = __fmaf_rn(sc[x], sl2, nm[i]);"),
}
UNCHECKED = ("no_loads", "no_exp")      # their output is not the function


def build(_build, shipped, against: Path | None) -> dict:
    """Compile every variant (and the sources in ``against``) in parallel;
    load and bind each."""
    text = (SRC / "flash_fwd.cu").read_text()
    sources = {name: patch(text) for name, patch in VARIANTS.items()}
    same = [name for name, t in sources.items() if t == text]
    if same:
        raise SystemExit(f"chip_flash: variants {same} change nothing")
    if against:
        sources["against"] = None
    jobs = {}
    for name, patched in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in (against if patched is None else SRC).glob("*.cu*"):
            shutil.copy(f, d / f.name)
        if patched is not None:
            (d / "flash_fwd.cu").write_text(patched)
        so = d / "flash_fwd.so"
        jobs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(d / "flash_fwd.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            for other, _ in jobs.values():
                other.kill()
            raise SystemExit(f"chip_flash: nvcc failed on {name}:\n{log}")
        for entry, e in _build.ptxas_entries(log).items():
            if "bf16" in entry:
                print(f"[build] {name}: {entry}: {e['registers']} registers,"
                      f" {e['spill_stores']} / {e['spill_loads']} bytes of "
                      "spill stores / loads", flush=True)
        for line in log.splitlines():
            if "C75" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        # the launch is all that flash_fwd calls (an older library may
        # lack the rest)
        lib.flash_fwd_launch.argtypes = shipped.flash_fwd_launch.argtypes
        lib.flash_fwd_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def sass_report(so: Path) -> None:
    """Write the SASS of flash_fwd_bf16<128> in library ``so`` under OUT
    and print its opcode counts, most frequent first."""
    import collections
    import re
    cuobjdump = Path(shutil.which("cuobjdump") or
                     "/usr/local/cuda/bin/cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    blocks = re.split(r"\n\s+Function : ", text)
    body = next((b for b in blocks if b.startswith("_Z") and
                 "flash_fwd_bf16ILi128E" in b.split("\n", 1)[0]), "")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "flash_fwd_bf16_128.sass").write_text(body)
    ops = collections.Counter(
        m.group(1).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
            body))
    print(f"[sass] flash_fwd_bf16<128>: {sum(ops.values())} instructions: "
          + ", ".join(f"{k} {v}" for k, v in ops.most_common(40)),
          flush=True)


def main(argv) -> int:
    against = None
    if argv[:1] == ["--against"] and len(argv) == 2:
        against = Path(argv[1]).resolve()
    elif argv:
        print("usage: chip_flash.py [--against CSRC_DIR]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_flash: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as Fa
    smoke = cs.Smoke(torch)
    shipped = Fa.build()[0]
    sass_report(Path(shipped._name))
    libs = build(_build, shipped, against)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)

    def use(lib):
        _build._loaded["flash_fwd"] = lib

    ok = True
    q, k, v = smoke.attn_inputs(1, 32, 8, 4096, 120, "bfloat16")
    flat = [x.transpose(1, 2).reshape(-1, 4096, 120).contiguous()
            for x in (q, k, v)]
    o_ref, l_ref = Fa.attention_ref(*(x.float() for x in flat), window=1024)
    for name, lib in libs.items():
        if name in UNCHECKED:
            continue
        use(lib)
        o, lse = Fa.flash_fwd(*flat, window=1024)
        torch.cuda.synchronize()
        good, eo, msg = smoke.attn_close(o, lse, o_ref, l_ref,
                                         *cs.FLASH_TOL["bfloat16"])
        ok &= good
        print(f"[check] {name}: {msg} {'ok' if good else 'FAILED'}",
              flush=True)
    del q, k, v, flat, o_ref, l_ref
    # the card's SM clock and power draw while the timings run
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
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
            lib_ms = smoke.sdpa_ms(q, k, v, 0)
            print(f"[timing] {shape}: one causal scaled_dot_product_attention"
                  f" {lib_ms:.4f} ms; card {card}", flush=True)
        for name, lib in libs.items():
            t = [ms(shipped), ms(lib), ms(lib), ms(shipped)]
            print(f"[timing] {shape}: shipped {t[0]:.4f} / {t[3]:.4f} ms, "
                  f"{name} {t[1]:.4f} / {t[2]:.4f} ms: {name} takes "
                  f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}x; card {card}",
                  flush=True)
        del q, k, v, views
    smi.terminate()
    samples = sorted(tuple(float(x) for x in line.split(","))
                     for line in smi.communicate()[0].splitlines()
                     if line.count(",") == 1)
    if samples:
        mhz = sorted(x[0] for x in samples)
        watts = sorted(x[1] for x in samples)
        print(f"[clocks] {len(samples)} samples while timing: SM clock "
              f"{mhz[0]:.0f} / {mhz[len(mhz) // 2]:.0f} / {mhz[-1]:.0f} MHz,"
              f" power draw {watts[0]:.1f} / {watts[len(watts) // 2]:.1f} / "
              f"{watts[-1]:.1f} W (min / median / max); card {card}",
              flush=True)
    use(shipped)
    print("chip_flash: " + ("all variants agree with the plain version" if ok
                            else "a variant FAILED its check"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
