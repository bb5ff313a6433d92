#!/usr/bin/env python3
"""Where the int8 conv kernel's ring path spends its time, on one CUDA card:
the kernel timed whole and with each of its phases skipped.

    python3 ccdm_tpu_torch/tools/phase_quant_conv.py

The card has no `ncu`, so the phases are taken out instead: the script
copies `csrc/quant_conv.cu` under `build/quant_phases/`, guards three of
the ring kernel's phases with a mask read at launch (1: the products, 2:
the next row's loads and quantization, 4: the output row's writes), builds
the copy alone and calls it through the package's plan at the ring sites
of the flagship's and Cityscapes' largest convolutions, bf16 on a static
scale. The whole run is checked bit for bit against the plain version
first; the others compute garbage. Each is timed with `chip_smoke.time_ms`.
The phases overlap little, so whole minus a phase skipped reads that
phase's cost. One JSON object per line; the last says `{"done": true}`.
"""

from __future__ import annotations

import ctypes
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "build" / "quant_phases"
# (NCHW input, Cout): 3x3 stride 1, the ring path
SITES = [((128, 32, 128, 128), 32), ((2, 128, 256, 512), 128), ((2, 256, 256, 512), 128),
         ((2, 256, 128, 256), 256), ((2, 256, 64, 128), 256)]
MASKS = {"whole": 0, "no_products": 1, "no_loads": 2, "no_writes": 4, "skeleton": 7}
# the ring kernel's phases and the C entry point, as in csrc/quant_conv.cu
GUARDS = [
    ("  int ring_bytes, w_bytes, stage_pitch;\n",
     "  int ring_bytes, w_bytes, stage_pitch;\n  int skip;\n"),
    ("    if (computes) {\n      for (int r = 0; r < a.ks; ++r) {",
     "    if (computes && !(a.skip & 1)) {\n      for (int r = 0; r < a.ks; ++r) {"),
    ("    if (a.vec && next) {", "    if (a.vec && next && !(a.skip & 2)) {"),
    ("    // 4. the next row's codes into the slots row oy no longer needs\n    if (next) {",
     "    // 4. the next row's codes into the slots row oy no longer needs\n"
     "    if (next && !(a.skip & 2)) {"),
    ("    // 5. output row oy, along W\n    {", "    // 5. output row oy, along W\n"
     "    if (!(a.skip & 4)) {"),
    ("    a.tw = p0, a.bn = p1, a.rs = p2;\n",
     "    a.tw = p0, a.bn = p1, a.rs = p2;\n    a.skip = ccdm_skip_phases;\n"),
    ('extern "C" int ccdm_quant_conv(',
     'static int ccdm_skip_phases = 0;\n'
     'extern "C" void ccdm_set_skip_phases(int mask) { ccdm_skip_phases = mask; }\n\n'
     'extern "C" int ccdm_quant_conv('),
]


def build(build_mod):
    """The guarded copy of the kernel, built alone; its ctypes handle."""
    csrc = REPO / "ccdm_tpu_torch" / "csrc"
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    src = (csrc / "quant_conv.cu").read_text()
    for old, new in GUARDS:
        if src.count(old) != 1:
            raise SystemExit(f"phase_quant_conv: the kernel's source no longer has {old!r}")
        src = src.replace(old, new)
    (OUT / "quant_conv.cu").write_text(src)
    shutil.copy(csrc / "common.cuh", OUT / "common.cuh")
    lib = OUT / "libquant_phases.so"
    subprocess.run([build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-shared", "-I", str(OUT), "-o",
                    str(lib), str(OUT / "quant_conv.cu")], check=True, capture_output=True)
    handle = ctypes.CDLL(str(lib))
    handle.ccdm_quant_conv.argtypes = build_mod._SIGNATURES["ccdm_quant_conv"]
    handle.ccdm_quant_conv.restype = ctypes.c_int
    handle.ccdm_set_skip_phases.argtypes = [ctypes.c_int]
    return handle


def main() -> None:
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("phase_quant_conv: needs a CUDA card")
    from ccdm_tpu_torch.ops import _build, quant

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    lib = build(_build)
    print(json.dumps({"kind": "device", "card": card}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape, cout in SITES:
        cin = shape[1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2).to(torch.bfloat16)
        weight = torch.randn(cout, cin, 3, 3, generator=gen, device="cuda") / math.sqrt(cin * 9)
        bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
        w_q, s_w = quant.weight_codes(weight)
        s_x = quant.static_act_scale(x.abs().amax() * 0.7)
        out = torch.empty(shape[0], cout, shape[2], shape[3], dtype=x.dtype, device="cuda")
        plan = quant._plan_conv(tuple(shape), cout, 3, 1, x.dtype)
        if plan.path != "ring":
            raise SystemExit(f"phase_quant_conv: {shape} -> {cout} takes {plan.path}")

        def run():
            status = lib.ccdm_quant_conv(
                x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(), bias.data_ptr(), s_x.data_ptr(),
                out.data_ptr(), None, 1, *shape, cout, 3, 1, 1, -(-cin // 32) * 32, 1,
                *plan.args(), torch.cuda.current_stream().cuda_stream)
            if status:
                raise RuntimeError(f"phase_quant_conv: launch failed ({status})")

        times = {}
        for name, mask in MASKS.items():
            lib.ccdm_set_skip_phases(mask)
            if mask == 0:
                run()
                if not torch.equal(out, quant.quant_conv_plain(x, w_q, s_w, bias, s_x, 3, 1, 1)):
                    raise AssertionError(f"phase_quant_conv {shape}: the copy != plain")
            times[name] = chip_smoke.time_ms(run)
        whole = times["whole"]
        print(json.dumps({"kind": "site", "shape": list(shape), "cout": cout,
                          "plan": list(plan.args()), "ms": times,
                          "products_ms": whole - times["no_products"],
                          "loads_ms": whole - times["no_loads"],
                          "writes_ms": whole - times["no_writes"]}), flush=True)
        del x, out
    print(json.dumps({"done": True}), flush=True)


if __name__ == "__main__":
    main()
