#!/usr/bin/env python3
"""Planted faults in the flash-attention kernel (K8), held to ``chip_smoke.py``'s
check of K8 against its plain version.

    python3 tools/k8_planted_faults.py --workdir DIR    # DIR outside the checkout

For each fault below, copies ``src/repro_torch`` into ``DIR/<fault>``, plants
the fault in the copy's ``csrc/flash_attn.cu`` (the checkout is never
changed), builds every copy at once, then runs ``chip_smoke.check_flash`` on
each copy at llama3.2-3b's heads (24 / 8, Dh 128) for the long S, in bf16
and f32. ``none`` is the unchanged source, the control. Prints one line per
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
LOOP = "  for (int ik = 0; ik < nkt; ++ik) {\n"
FAULTS = {  # name → (what it does, [(text, replacement)] in flash_attn.cu)
    "none": ("the kernel as it is", []),
    "skip_tile": ("key tile 1 skipped for the query tiles past row 7680 (the last 512 rows at S = 8192)",
                  [(LOOP, LOOP + "    if (ik == 1 && nkt > 120) continue;\n")]),
    "skip_tile_last": ("key tile 1 skipped for the last query tile only (rows 8128-8191 at S = 8192)",
                       [(LOOP, LOOP + "    if (ik == 1 && nkt == 128) continue;\n")]),
    "p_unrounded": ("p kept in f32 for the p v product (not rounded to v's dtype)",
                    [("round_as(p0, T())", "p0"), ("round_as(p1, T())", "p1")]),
    "store_truncated": ("the bf16 output rounded toward zero instead of to nearest",
                        [("*p = __float2bfloat16(v);", "*p = __float2bfloat16_rz(v);")]),
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
