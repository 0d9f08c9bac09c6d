"""The backlog mix: a closed loop. Before every wave the pending pods
(active, backoff and unschedulable) are topped up to the mix's `pending`
with fresh pods; set-up runs `warmup_waves` such waves."""

import time

from benchmark.harness import window


def drive(run, mix: dict, seconds: float, trace: bool, ctx: dict,
          seed: int) -> None:
    def feed():
        need = int(mix["pending"]) - run.pending
        if need > 0:
            run.add_fresh(need)

    t = time.time()
    for i in range(int(mix["warmup_waves"])):
        feed()
        run.wave()
        if i == 0:
            ctx["setup_parts"]["first_wave"] = time.time() - t
    ctx["setup_parts"]["warmup"] = time.time() - t
    window(run, mix, seconds, trace, ctx, feed)
