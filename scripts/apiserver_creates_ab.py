#!/usr/bin/env python3
"""Phase 11a's creates — make_nodes(5000) and flagship_pods(10000) through
Client.local into a fresh in-memory APIServer (chip_smoke.py `_create`) —
timed in several checkouts of the repo, in turns, each run a process of
its own. Prints one line per run and a JSON object of creates/s per tree.

    python3 scripts/apiserver_creates_ab.py --tree parent=<dir> \\
        --tree change=. [--rounds 10]

A tree is a checkout root holding chip_smoke.py and kubernetes_tpu_torch/
(`git archive <commit>` unpacked). Host code only: the apiserver holds no
device state, and the numbers are the host's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CODE = r'''
import sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as C
api = C.port_server_api(torch.device("cpu"))
W = api.workloads
srv = api.APIServer()
client = api.Client.local(srv)
s = C._create(client, api, W.make_nodes(5000), W.flagship_pods(10000))
print(15000 / s, type(srv.storage.kv).__name__)
srv.close()
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="name=checkout root")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    trees = [(name, os.path.abspath(root))
             for name, root in (t.split("=", 1) for t in args.tree)]
    runs = {name: [] for name, _ in trees}
    for i in range(args.rounds):
        for name, root in (trees if i % 2 == 0 else trees[::-1]):
            out = subprocess.run([sys.executable, "-c", CODE, root],
                                 capture_output=True, text=True, cwd=root,
                                 check=True)
            rate, kind = out.stdout.strip().splitlines()[-1].split()
            runs[name].append(float(rate))
            print(name, kind, rate, flush=True)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
