"""The port's API surface under the conformance sweep, held against the
JAX package's.

tests/test_conformance.py's cases, each run on both packages
(tests/test_torch_twin.py `mirror`): every resource the scheme serves goes
through the full verb set on each — create, get (+404), list, update (+409
on a stale resourceVersion), patch, watch, delete (+404 after) — and every
request the case made through its client (`handle_rest`: method, path,
query, body, and the status code and object answered, or the error class
and code raised) is the same on both. The reference's fixtures are module-
scoped; the mirror builds them for each case and each package.
"""

from test_torch_twin import mirror

mirror(globals(), "test_conformance",
       record=["apiserver.server.handle_rest"])
