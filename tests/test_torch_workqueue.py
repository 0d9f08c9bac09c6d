"""The port's workqueues (kubernetes_tpu_torch/client/workqueue.py: the
dedup/dirty/processing queue, the delaying queue, the per-item exponential
rate limiter), held against the JAX package's.

tests/test_client.py's TestWorkQueue cases, each run on both packages
(tests/test_torch_twin.py `mirror`), every add, get, done and requeue count
answering the same on both. Beyond them: one seeded script of adds, gets,
dones and rate-limited adds gives the same items in the same order, and the
rate limiter the same delays. All host code: equality is exact.
"""

import numpy as np
import pytest
from test_torch_twin import mirror

from kubernetes_tpu.client import workqueue as jwq
from kubernetes_tpu_torch import client as tclient
from kubernetes_tpu_torch.client import workqueue as twq

mirror(globals(), "test_client",
       select=lambda cls, name: cls == "TestWorkQueue",
       record=["client.workqueue.WorkQueue.add",
               "client.workqueue.WorkQueue.get",
               "client.workqueue.WorkQueue.done",
               "client.workqueue.WorkQueue.__len__",
               "client.workqueue.RateLimitingQueue.num_requeues"])


def test_exported_from_the_client_package():
    for name in ("WorkQueue", "DelayingQueue", "RateLimiter",
                 "RateLimitingQueue"):
        assert getattr(tclient, name) is getattr(twq, name)


@pytest.mark.parametrize("seed", range(3))
def test_seeded_script_same_order(seed):
    out = []
    for wq in (jwq, twq):
        rng = np.random.default_rng(seed)
        q, log = wq.WorkQueue(), []
        held = []
        for _ in range(300):
            op = rng.integers(4)
            if op < 2:
                q.add(f"k{rng.integers(12)}")
            elif op == 2 and len(q):
                item = q.get(timeout=1)
                log.append(("get", item))
                held.append(item)
            elif held:
                item = held.pop(int(rng.integers(len(held))))
                q.done(item)
                log.append(("done", item))
            log.append(len(q))
        q.shutdown()
        lim = wq.RateLimiter(base=0.005, max_delay=2.0)
        log.append([lim.when("x") for _ in range(12)])
        lim.forget("x")
        log.append(lim.when("x"))
        out.append(log)
    assert out[1] == out[0]
