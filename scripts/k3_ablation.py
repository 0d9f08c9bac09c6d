#!/usr/bin/env python3
"""Where K3's device time goes: the shipped reprieve_scan kernel against
copies of its source with one part taken out, timed on one card.

    python3 scripts/k3_ablation.py [--reps 50]

Each variant is the source of kubernetes_tpu_torch/csrc/reprieve_scan.cu
with one text edit, built with the same nvcc flags into build/ablation/:

  * no-walk     — pass 2 never runs (no reprieve walk, no summaries);
  * no-flags    — the per-lane flag bytes (vict_pot, c_e, reblock) are not
                  read: every pod is a potential victim of every lane, with
                  no clash and no reblock;
  * no-gathers  — the pods' request rows, priority, creation and PDB bytes
                  are not read (each request slot taken as 1);
  * no-sums     — pass 1's warp reductions of the request slots are skipped;
  * outputs     — only the node's loads and the output writes run.

A variant computes a different function, so its output is not checked; the
shipped kernel is held exactly against its plain version first. Times come
from chip_smoke.py's device_ms (CUDA events over back-to-back launches, the
wrapper's allocations included) at chip_smoke.py's K3 case with the storm's
widths (8 lanes, 5,000 nodes, 50,000 pods, R = 4), and at its 2,000-pod
segment (4 lanes on 2 nodes: one warp walks 2,000 positions). Prints one
JSON line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FLAGS = ("f[u] = (a.vict_pot[row] != 0) | ((a.c_e[row] != 0) << 1) |\n"
         "                 ((a.reblock[row] != 0) << 2);")
ROWS = ("for (int r = 0; r < R; ++r) "
        "q[r] = (uint32_t)a.req_e[(size_t)e * R + r];\n"
        "      }\n"
        "      s.prio[i] = a.prio_e[e];\n"
        "      s.cre[i] = a.creation_e[e];\n"
        "      pdb = a.pdb_e[e] != 0;")
SUMS = ("if (vm != 0) {\n#pragma unroll\n"
        "            for (int r = 0; r < nr; ++r) {")
EDITS = {
    "no-walk": [("if (__any_sync(kFull, cand)) {",
                 "if (false && __any_sync(kFull, cand)) {")],
    "no-flags": [(FLAGS, "f[u] = 1u + 0u * (unsigned)row;")],
    "no-gathers": [(ROWS, "for (int r = 0; r < R; ++r) q[r] = 1u;\n"
                          "      }\n"
                          "      s.prio[i] = e;\n"
                          "      s.cre[i] = e;\n"
                          "      pdb = false;")],
    "no-sums": [(SUMS, SUMS.replace("if (vm != 0)", "if (false)"))],
    "outputs": [("    if (lanes != 0) {", "    if (false) {")],
}


def build_variants(K, out_dir):
    """Write and build every variant, all nvcc runs started together."""
    src = (K.CSRC / "reprieve_scan.cu").read_text()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"k3_ablation: edit for {name} does not "
                                 "match the kernel source once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-o", lib, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k3_ablation: build of {name} failed:\n{log}")
        libs[name] = lib
    return libs


def load(K, path):
    lib = ctypes.CDLL(path)
    fn = lib.reprieve_scan_launch
    fn.argtypes = K._ARGTYPES["reprieve_scan_launch"]
    fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k3_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kubernetes_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    K.build(("reprieve_scan",))
    shipped = K._library("reprieve_scan")
    libs = build_variants(K, str(K.BUILD_DIR.parent / "ablation"))
    named = dict(cs.k3_edge_cases(dev))
    cases = {"storm widths": named["storm widths B=8 N=5000 E=50000 R=4"],
             "2000-pod segment": named["2000-pod segment B=4 N=2 E=4000"]}
    out = {"card": card, "us": {}}
    for case, a in cases.items():
        if cs.k3_diff(K.reprieve_scan(*a), K.reprieve_scan_plain(*a)):
            raise SystemExit(f"k3_ablation: K3 disagrees with its plain "
                             f"version ({case})")
    try:
        for name, path in [("shipped", None)] + list(libs.items()):
            K._LIBS["reprieve_scan"] = shipped if path is None else \
                load(K, path)
            out["us"][name] = {
                case: cs.device_ms(lambda: K.reprieve_scan(*a), dev,
                                   reps=args.reps) * 1e3
                for case, a in cases.items()}
    finally:
        K._LIBS["reprieve_scan"] = shipped
    for name, row in out["us"].items():
        print(f"  {name:11s} " + "  ".join(f"{case} {us:8.2f} us"
                                           for case, us in row.items()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
