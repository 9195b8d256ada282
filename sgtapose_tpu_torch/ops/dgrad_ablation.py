"""Where bf16 training's DCN data gradient spends its time, on one NVIDIA GPU.

    python -m sgtapose_tpu_torch.ops.dgrad_ablation

Builds `csrc/deform_conv_dgrad_bf16.cu` as it is and three ablations of it
(each a copy of the source with one part switched off, compiled by nvcc with
the port's flags into build/torch_kernels/ablation/), then times each with
`models/deform_conv.deform_conv_dgrad_cuda` at the 16 decoder nodes of a
bf16 training step (480x480, batch 8, offsets in [-3, 3] px), cold (L2
flushed before each call), beside the yardstick it replaced
(`deform_conv_dgrad_halo_cuda`) and the unfused pair (dY W in bf16, then
`deform_sample_bwd_bf16`). The ablations give wrong gradients on purpose:
  no_atomics  the scatter without its float4 atomics into dx;
  no_scatter  no item arithmetic, loads or atomics (the products, the
              dcols tile, the per-item shuffles and dom stay);
  no_copies   no_scatter and the ring's copies skipped as well (the products
              read stale tiles).
The kernel's own call is checked against the plain version first. Prints the
card's name and power limit, one JSON line per node and one with the sums;
writes chiprun_out/dgrad_ablation.json.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# (H, C_in, C_out, nodes per step) of the 16 decoder DCN nodes at 480x480
NODES = [(15, 512, 256, 1), (30, 256, 256, 1), (30, 256, 128, 2), (30, 256, 64, 1),
         (60, 128, 128, 2), (60, 128, 64, 4), (120, 64, 64, 5)]
BATCH = 8
REL_TOL = 2.0 ** -6  # chip_smoke.py: BWD_BF16_REL_TOL
NO_SCATTER = ("      if (lim > 0 && pixel(r) >= 0) {", "      if (lim > 0 && pixel(r) >= 0 && H < 0) {")
ABLATIONS = {
    "no_atomics": [("if (f.w[q] != 0.f) add_dx4<VEC>(", "if (f.w[q] == -1.f) add_dx4<VEC>(")],
    "no_scatter": [NO_SCATTER],
    "no_copies": [NO_SCATTER, ("    if (t >= steps) return;", "    if (t >= 0) return;")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dgrad_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from sgtapose_tpu_torch.models import deform_conv as dc
    from sgtapose_tpu_torch.ops import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    name = dc.DGRAD_KERNEL_BF16
    libs = {"kernel": build.build_all()[name]}
    src = (build.CSRC / build.KERNEL_SOURCES[name]).read_text()
    procs = {}
    for abl, edits in ABLATIONS.items():
        out = build.BUILD_ROOT / "ablation" / abl
        out.mkdir(parents=True, exist_ok=True)
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ablation {abl}: {old!r} is not in {build.KERNEL_SOURCES[name]}")
            text = text.replace(old, new, 1)
        (out / "k.cu").write_text(text)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, out / header.name)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / "lib.so"), str(out / "k.cu")]
        procs[abl] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fn_name, argtypes = build._SIGNATURES[name]
    for abl, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"ablation {abl}: nvcc exit {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(build.BUILD_ROOT / "ablation" / abl / "lib.so"))
        getattr(lib, fn_name).argtypes = argtypes
        getattr(lib, fn_name).restype = ctypes.c_int
        libs[abl] = lib

    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)

    def cold_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    gen = torch.Generator(device=dev).manual_seed(0)
    rows, sums = [], {}
    for H, C, O, per_step in NODES:
        x = torch.randn(BATCH, H, H, C, generator=gen, device=dev).to(bf)
        om = torch.cat([torch.rand(BATCH, H, H, 18, generator=gen, device=dev) * 6 - 3,
                        2 * torch.randn(BATCH, H, H, 9, generator=gen, device=dev)], dim=-1).to(bf)
        weight = (torch.randn(O, 9 * C, generator=gen, device=dev) / math.sqrt(9 * C)).to(bf)
        dy = torch.randn(BATCH, H, H, O, generator=gen, device=dev).to(bf)
        offsets, masks = dc.sample_inputs(om)
        dx, dom = dc.deform_conv_dgrad_cuda(x, om, weight, dy)
        rdx, rdom = dc.plain_deform_conv_dgrad(x, om, weight, dy)
        for got, ref in ((dx, rdx), (dom, rdom)):
            err = (got.float() - ref.float()).abs().max().item() / max(1.0, ref.float().abs().max().item())
            if not err <= REL_TOL:
                raise AssertionError(f"deform_conv_dgrad_bf16 H={H} C={C} O={O}: rel err {err} > {REL_TOL}")
        row = {"H": H, "C": C, "O": O, "per_step": per_step}
        row["pair_ms"] = cold_ms(lambda: dc.deform_sample_bwd_cuda(
            x, offsets, masks, (dy.view(-1, O) @ weight).view(BATCH, H, H, 9 * C)))
        row["yardstick_ms"] = cold_ms(lambda: dc.deform_conv_dgrad_halo_cuda(x, om, weight, dy))
        for abl, lib in libs.items():
            build._LIBS[name] = lib
            row[f"{abl}_ms"] = cold_ms(lambda: dc.deform_conv_dgrad_cuda(x, om, weight, dy))
        build._LIBS[name] = libs["kernel"]
        rows.append(row)
        print(json.dumps(row))
        for key, val in row.items():
            if key.endswith("_ms"):
                sums[key] = sums.get(key, 0.0) + per_step * val
        del x, om, weight, dy, offsets, masks, dx, dom, rdx, rdom
    report = {"card": card, "batch": BATCH, "offsets_px": 3, "rows": rows, "ms_per_step": sums}
    print(json.dumps({"ms_per_step": sums}))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "dgrad_ablation.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
