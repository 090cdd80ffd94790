#!/usr/bin/env python3
"""Planted faults in the flash-attention kernel (K8), held to ``chip_smoke.py``'s
check of K8 against its plain version.

    python3 tools/k8_planted_faults.py --workdir DIR    # DIR outside the checkout

For each fault below, copies ``src/repro_torch`` into ``DIR/<fault>``, plants
the fault in the copy's ``csrc/flash_attn.cu``, in the bf16 kernel on the
tensor cores (the checkout is never changed; a patch text that is not in the
source exactly once stops the run), builds every copy at once, then runs
``chip_smoke.check_flash`` on
each copy at llama3.2-3b's heads (24 / 8, Dh 128) for the long S, in bf16
and f32 (f32 runs the CUDA-core kernel, which carries no fault: a second
control). ``none`` is the unchanged source, the control. Prints one line per
check, where the check caught each fault and where its absolute limit alone
would have, and writes the records to
``chiprun_out/k8_planted_faults.json``. Exits non-zero if the control fails.
Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TILE = "    const int k0 = it * kBK;\n"  # the consumers' key-tile loop


def skip_tile_one(cond: str) -> str:
    """Consumers take key tile 1's copies off the ring without using them
    (the producer still sends it, so the barriers stay in step)."""
    return (TILE + f"    if (it == 1 && {cond}) {{\n"
            "      mbar_wait(&full_k[st], ph);\n      mbar_wait(&full_v[st], ph);\n"
            "      mbar_arrive(&empty[st]);\n      continue;\n    }\n")


PV = """      wgmma_pv<DHP>(o, pa + 4 * kk, desc_sw128(vt + kk * 16 * 128, kBlock, 1024));\n"""
PV_MARK = "    // O += P V over the tile's keys, 16 keys a step\n"
RESIDUAL = """    uint32_t pr[32];  // p - bf16(p), so P V sees p to ~16 bits more
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float a = s[2 * i], b = s[2 * i + 1];
      pr[i] = pack_bf16(a - __bfloat162float(__float2bfloat16(a)), b - __bfloat162float(__float2bfloat16(b)));
    }
"""
FAULTS = {  # name → (what it does, [(text, replacement)] in flash_attn.cu's bf16 kernel)
    "none": ("the kernel as it is", []),
    "skip_tile": ("key tile 1 skipped for the query tiles past row 7680 (the last 512 rows at S = 8192)",
                  [(TILE, skip_tile_one("nkt > 60"))]),
    "skip_tile_last": ("key tile 1 skipped for the last query tile only (rows 8064-8191 at S = 8192)",
                       [(TILE, skip_tile_one("nkt == 64"))]),
    "p_unrounded": ("p not rounded to bf16 for the p v product (a second product adds p - bf16(p))",
                    [(PV_MARK, RESIDUAL + PV_MARK),
                     (PV, "    {\n" + PV + PV.replace("pa + 4", "pr + 4") + "    }\n")]),
    "store_truncated": ("the bf16 output rounded toward zero instead of to nearest",
                        [("__floats2bfloat162_rn(o[4 * j + 2 * r] / li, o[4 * j + 2 * r + 1] / li)",
                          "__halves2bfloat162(__float2bfloat16_rz(o[4 * j + 2 * r] / li), "
                          "__float2bfloat16_rz(o[4 * j + 2 * r + 1] / li))")]),
}
SHAPES = [(1, 2048), (1, 8192), (4, 8192)]  # (B, S)


def plant(workdir: Path, name: str) -> Path:
    dst = workdir / name / "src" / "repro_torch"
    shutil.rmtree(dst.parents[1], ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst, ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "csrc" / "flash_attn.cu"
    text = cu.read_text()
    for old, new in FAULTS[name][1]:
        if text.count(old) != 1:
            raise SystemExit(f"k8_planted_faults: {name}: {old!r} is not in flash_attn.cu exactly once")
        text = text.replace(old, new)
    cu.write_text(text)
    return dst.parent


def child(mode: str) -> None:
    import torch

    sys.path.append(str(ROOT))  # chip_smoke; repro_torch comes from PYTHONPATH, the copy
    import chip_smoke
    import repro_torch
    from repro_torch.kernels import _build

    if mode == "build":
        _build.build(["flash_attn"])
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    H, Hkv, Dh = chip_smoke.LLAMA_HEADS
    recs = [chip_smoke.check_flash(b, s, H, Hkv, Dh, dt, gen)
            for b, s in SHAPES for dt in (torch.bfloat16, torch.float32)]
    print(json.dumps({"package": repro_torch.__file__, "records": recs}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", type=Path, required=False)
    ap.add_argument("--child", choices=("build", "check"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    if args.workdir is None:
        ap.error("--workdir is required")
    workdir = args.workdir.resolve()
    if workdir == ROOT or ROOT in workdir.parents:
        ap.error("--workdir must lie outside the checkout: the faults are planted in copies")
    srcs = {name: plant(workdir, name) for name in FAULTS}

    def run(name, mode, **kw):
        env = dict(os.environ, PYTHONPATH=str(srcs[name]))
        return subprocess.Popen([sys.executable, __file__, "--child", mode], env=env, text=True, **kw)

    builds = {name: run(name, "build", stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for name in FAULTS}
    for name, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k8_planted_faults: {name} did not build:\n{out[-3000:]}")
    results = {}
    for name, (what, _) in FAULTS.items():
        print(f"[{name}] {what}", flush=True)
        proc = run(name, "check", stdout=subprocess.PIPE)
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k8_planted_faults: the check of {name} did not run")
        for line in out.splitlines()[:-1]:
            print(line, flush=True)
        res = json.loads(out.splitlines()[-1])
        if not res["package"].startswith(str(srcs[name])):
            raise SystemExit(f"k8_planted_faults: {name} imported {res['package']}, not its copy")
        recs = res["records"]
        def where(bad):
            return [f"B={r['B']} S={r['S']} {r['dtype']}" for r in recs if bad(r)]

        caught = where(lambda r: not r["ok"])
        by_abs = where(lambda r: r["max_abs_err"] > r["tol"])  # what the absolute limit alone sees
        results[name] = {"what": what, "caught_at": caught, "abs_limit_alone_at": by_abs, "records": recs}
        print(f"[{name}] {'caught at ' + ', '.join(caught) if caught else 'not caught'}; the absolute limit "
              f"alone: {', '.join(by_abs) if by_abs else 'nowhere'}", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "k8_planted_faults.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({name: len(r["caught_at"]) for name, r in results.items()}), flush=True)
    return 1 if results["none"]["caught_at"] else 0


if __name__ == "__main__":
    sys.exit(main())
