"""The port's admission webhooks and audit log
(kubernetes_tpu_torch/apiserver/webhooks.py, wired into APIServer._admit
and handle_rest), held against the JAX package's.

tests/test_webhooks_audit.py's cases, each run on both packages
(tests/test_torch_twin.py `mirror`): validating and mutating webhooks,
failure policies, rules, namespace and object selectors, the admission
order (built-in mutate, mutating webhooks, built-in validate, validating
webhooks: a mutating webhook cannot dodge quota or a LimitRange maximum),
the audit ring and its JSONL file sink, the authenticated user through the
gateway. Every apiserver request, webhook dispatch and audit read returns
the same objects, status codes and audit events (less their timestamps) on
both. All host code: equality is exact.
"""

from test_torch_twin import mirror

mirror(globals(), "test_webhooks_audit", record=[
    "apiserver.server.handle_rest", "apiserver.registry.Store.create",
    "apiserver.webhooks.WebhookDispatcher.dispatch",
    "apiserver.webhooks.AuditLog.events",
    "client.rest.HTTPTransport.request"])
