"""Run a JAX-package test file's cases on both packages, and compare.

`mirror(namespace, "test_x", record=[...])` loads tests/test_x.py twice: as
it is (the JAX package) and with every `kubernetes_tpu` import rebound to
`kubernetes_tpu_torch` (the port; `subs` edits the source first where the
port's API differs, e.g. a Scheduler on the CPU needs `device="cpu"`). Each
of the file's test cases becomes one test of the calling file, under the
same class and name, which runs the case on the JAX package and then on the
port, each with its own fixtures (the file's fixtures resolved per package,
`tmp_path` a subdirectory per package, `monkeypatch` undone and `caplog`
cleared between the two), and holds the two runs to one outcome:

  * both pass: the reference's own assertions, with its exact expected
    values, hold on the port;
  * every call the case made, on its own thread, into the `record`ed entry
    points (dotted paths under each package, e.g. "machinery.codec.encode",
    "apiserver.server.handle_rest", "storage.native.DurableKV.txn_put")
    took the same arguments and returned the same value — or raised the
    same error class and status code — on both. Equality is exact, after
    turning objects into plain data: records and dataclasses into their
    fields, other objects into their class name, less the fields that differ
    from run to run (uids, timestamps; VOLATILE);
  * with `files=True`, the files each run left under its tmp_path are
    equal byte for byte (the WAL segments and snapshots);
  * with `writes=True`, the set of writes the apiserver accepted through
    a client is equal: every create and Binding of every thread (the
    case's, the controllers', the kubelets', the scheduler's) and every
    delete the case made, each as its verb and its path (a create with the
    name or generateName it asked for), the registry's generated name
    suffixes and the `scrub` patterns applied (WriteLog). A set, not a
    sequence: which of two threads writes first, and how often, follows the
    host's timing in either package.

Everything compared is host code, so no tolerance applies anywhere. The
tests below hold the helpers themselves to that contract.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import re
import sys
import threading
import types
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import pytest

TESTS = Path(__file__).resolve().parent
PACKAGES = {"jax": "kubernetes_tpu", "port": "kubernetes_tpu_torch"}
VOLATILE = {"uid", "creationTimestamp", "lastTransitionTime",
            "firstTimestamp", "lastTimestamp", "eventTime", "renewTime",
            "acquireTime", "deletionTimestamp", "writtenAt", "ts",
            "timestamp", "requestReceivedTimestamp", "stageTimestamp"}
BUILTINS = ("tmp_path", "monkeypatch", "caplog", "request")
# a local server's ephemeral port differs from run to run
PORT_SCRUB = [(r"(127\.0\.0\.1|localhost):\d+", r"\1:<port>")]

_TWINS: Dict[Tuple[str, Tuple], types.ModuleType] = {}


def port_twin(name: str, subs: Sequence[Tuple[str, str]] = ()
              ) -> types.ModuleType:
    """tests/<name>.py with `subs` applied and every import of the JAX
    package rebound to the port, as a module of its own."""
    key = (name, tuple(subs))
    if key in _TWINS:
        return _TWINS[key]
    path = TESTS / f"{name}.py"
    src = path.read_text()
    for old, new in subs:
        if old not in src:
            raise ValueError(f"{name}: {old!r} not in the source")
        src = src.replace(old, new)
    src = re.sub(r"\bkubernetes_tpu\b", "kubernetes_tpu_torch", src)
    mod = types.ModuleType(f"{name}_on_port")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    _TWINS[key] = mod
    return mod


# --------------------------------------------------------------------- #
# normalisation
# --------------------------------------------------------------------- #


def norm(x, tmp: str = "", scrub: Sequence[Tuple[str, str]] = (),
         drop: frozenset = frozenset()):
    """`x` as plain data, comparable across the two packages; `tmp` (a run's
    own tmp_path) reads as "<tmp>" inside strings, and each (pattern,
    replacement) of `scrub` is applied to them (names with a random part).
    `drop` names more keys and dataclass fields to leave out (clock
    readings)."""
    def n(v):
        return norm(v, tmp, scrub, drop)

    if isinstance(x, dict):
        return {str(k): n(v) for k, v in x.items()
                if k not in VOLATILE and k not in drop}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__, {f: n(getattr(x, f)) for f in x._fields})
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: n(getattr(x, f.name))
                                   for f in dataclasses.fields(x)
                                   if f.name not in drop})
    if isinstance(x, (list, tuple)):
        return [n(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(repr(n(v)) for v in x)
    if isinstance(x, (bytes, bytearray)):
        return bytes(x)
    if isinstance(x, str):
        x = x.replace(tmp, "<tmp>") if tmp else x
        for pattern, repl in scrub:
            x = re.sub(pattern, repl, x)
        return x
    if isinstance(x, Path):
        return n(str(x))
    if x is None or isinstance(x, (int, float, bool)):
        return x
    if isinstance(x, BaseException):
        return ("raise", type(x).__name__, getattr(x, "code", None))
    return f"<{type(x).__name__}>"


# --------------------------------------------------------------------- #
# recording
# --------------------------------------------------------------------- #


def _resolve(pkg: str, path: str):
    """(owner, attribute) for a dotted path under package `pkg`."""
    parts = path.split(".")
    for i in range(len(parts) - 1, 0, -1):
        try:
            owner = importlib.import_module(f"{pkg}.{'.'.join(parts[:i])}")
        except ModuleNotFoundError:
            continue
        for p in parts[i:-1]:
            owner = getattr(owner, p)
        return owner, parts[-1]
    raise ValueError(f"cannot resolve {pkg}.{path}")


class Recorder:
    """Wraps the recorded entry points of one package for one run; keeps
    each outermost call made on the installing thread."""

    def __init__(self, pkg: str, paths: Iterable[str], tmp: str = "",
                 scrub: Sequence[Tuple[str, str]] = (),
                 drop: Iterable[str] = ()):
        self.pkg, self.paths, self.tmp = pkg, list(paths), tmp
        self.scrub = PORT_SCRUB + list(scrub)
        self.drop = frozenset(drop)
        self.calls: List[tuple] = []
        self._tid = threading.get_ident()
        self._depth = 0
        self._saved: List[tuple] = []

    def _wrap(self, path: str, orig):
        rec = self

        def wrapper(*a, **kw):
            if threading.get_ident() != rec._tid or rec._depth:
                return orig(*a, **kw)
            rec._depth += 1
            try:
                out = orig(*a, **kw)
            except BaseException as e:
                rec._depth -= 1
                rec.calls.append((path, rec.norm(a), rec.norm(kw), rec.norm(e)))
                raise
            rec._depth -= 1
            rec.calls.append((path, rec.norm(a), rec.norm(kw),
                              rec.norm(out)))
            return out

        wrapper.__wrapped__ = orig
        return wrapper

    def norm(self, x):
        return norm(x, self.tmp, self.scrub, self.drop)

    def __enter__(self) -> "Recorder":
        for path in self.paths:
            owner, attr = _resolve(self.pkg, path)
            orig = (owner.__dict__[attr] if isinstance(owner, type)
                    else getattr(owner, attr))
            self._saved.append((owner, attr, orig))
            setattr(owner, attr, self._wrap(path, orig))
        return self

    def __exit__(self, *exc) -> None:
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()


# the apiserver's generated names: generateName + a 5-hex-digit sequence
# (apiserver/registry.py Store.create)
GENERATED = [(r"(?<=-)[0-9a-f]{5}(?=/|$)", "<seq>")]
EVENTS = re.compile(r"/events(/|$)")
class WriteLog:
    """Wraps both transports' `request` of one package for one run; keeps
    the set of writes the apiserver accepted as (verb, path[, name]) keys:
    every create (POST: objects, Bindings, evictions) of every thread and
    every delete the installing thread — the case itself — made, less every
    write to events (event recording is best-effort and its names are
    random). Updates are not
    kept, nor the deletes of the controllers', kubelets' and scheduler's
    threads: whether a status is rewritten once more, a node's heartbeat or
    lease renewal lands, a case's polling loop marks one more pod Running,
    or a controller trims a pod it made (a surplus replica, a duplicate
    daemon pod made on a stale lister, an old revision's pods) before the
    case ends follows the host's timing in either package (the mirrored
    files' cases, run repeatedly on the JAX package alone and under load,
    showed such writes in some runs and not in others, and no create). A
    refused write (a conflict, a delete of what is gone) changed nothing and
    is not kept."""

    def __init__(self, pkg: str, scrub: Sequence[Tuple[str, str]] = ()):
        self.pkg = pkg
        self.scrub = GENERATED + PORT_SCRUB + list(scrub)
        self.keys: set = set()
        self._tid = threading.get_ident()
        self._saved: List[tuple] = []

    def key(self, method: str, path: str, body) -> Optional[tuple]:
        own = threading.get_ident() == self._tid
        if EVENTS.search(path) or not (
                method == "POST" or (method == "DELETE" and own)):
            return None
        if method == "POST" and isinstance(body, dict):
            md = body.get("metadata") or {}
            path += "/" + (md.get("name") or
                           f"{md.get('generateName', '')}<generated>")
        for pattern, repl in self.scrub:
            path = re.sub(pattern, repl, path)
        return method, path

    def _wrap(self, orig):
        log = self

        def request(transport, method, path, query, body=None, *a, **kw):
            out = orig(transport, method, path, query, body, *a, **kw)
            k = log.key(method, path, body)
            if k is not None:
                log.keys.add(k)
            return out

        request.__wrapped__ = orig
        return request

    def __enter__(self) -> "WriteLog":
        rest = importlib.import_module(f"{self.pkg}.client.rest")
        for cls in (rest.LocalTransport, rest.HTTPTransport):
            orig = cls.__dict__["request"]
            self._saved.append((cls, orig))
            cls.request = self._wrap(orig)
        return self

    def __exit__(self, *exc) -> None:
        for cls, orig in reversed(self._saved):
            cls.request = orig
        self._saved.clear()


def first_difference(a: list, b: list) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"call {i}: JAX {x!r:.600}\n  port {y!r:.600}"
    return f"JAX made {len(a)} recorded calls, the port {len(b)}"


def tree_bytes(root: Path) -> Dict[str, bytes]:
    if not root.exists():
        return {}
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# --------------------------------------------------------------------- #
# fixtures, resolved per package
# --------------------------------------------------------------------- #


def _fixtures(mod) -> Dict[str, tuple]:
    out = {}
    for k, v in vars(mod).items():
        marker = getattr(v, "_fixture_function_marker", None)
        if marker is not None:
            out[marker.name or k] = (v._get_wrapped_function(), marker)
    return out


class _Request:
    """The `request` a parametrised fixture of the mirrored file reads."""

    def __init__(self, param):
        self.param = param


def _argnames(fn) -> List[str]:
    return [n for n in inspect.signature(fn).parameters if n != "self"]


def _mark_argnames(marks) -> List[str]:
    out = []
    for m in marks:
        if m.name == "parametrize":
            names = m.args[0]
            out += ([n.strip() for n in names.split(",")]
                    if isinstance(names, str) else list(names))
    return out


def _run_side(mod, cls_name: Optional[str], name: str, values: dict,
              builtins: dict) -> None:
    fx = _fixtures(mod)
    cache, teardowns = {}, []

    def get(arg):
        if arg in cache:
            return cache[arg]
        if arg in fx:
            fn, _marker = fx[arg]
            kw = {a: (_Request(values.get(arg)) if a == "request"
                      else get(a)) for a in _argnames(fn)}
            v = fn(**kw)
            if inspect.isgenerator(v):
                teardowns.append(v)
                v = next(v)
        elif arg in values:
            v = values[arg]
        else:
            v = builtins[arg]
        cache[arg] = v
        return v

    try:
        for fname, (_fn, marker) in fx.items():
            if marker.autouse:
                get(fname)
        if cls_name is None:
            fn = getattr(mod, name)
            fn(**{a: get(a) for a in _argnames(fn)})
        else:
            inst = getattr(mod, cls_name)()
            fn = getattr(inst, name)
            fn(**{a: get(a) for a in _argnames(fn)})
    finally:
        for gen in reversed(teardowns):
            try:
                next(gen)
            except StopIteration:
                pass


def _cleanup() -> None:
    for pkg in PACKAGES.values():
        importlib.import_module(f"{pkg}.utils.faultline").uninstall()


def _make_test(ref, twin, cls_name, name, argnames, record, files, scrub,
               writes=False, drop=()):
    def test(*_self, **kw):
        calls, trees, written = {}, {}, {}
        values = {k: v for k, v in kw.items() if k not in BUILTINS}
        for side, mod in (("jax", ref), ("port", twin)):
            builtins = dict(kw)
            if "tmp_path" in kw:
                builtins["tmp_path"] = kw["tmp_path"] / side
                builtins["tmp_path"].mkdir()
            if "caplog" in kw:
                kw["caplog"].clear()
            wlog = WriteLog(PACKAGES[side], scrub)
            try:
                tmp = str(builtins.get("tmp_path", ""))
                with Recorder(PACKAGES[side], record, tmp, scrub,
                              drop) as rec:
                    if writes:
                        with wlog:
                            _run_side(mod, cls_name, name, values, builtins)
                    else:
                        _run_side(mod, cls_name, name, values, builtins)
            finally:
                _cleanup()
                if "monkeypatch" in kw:
                    kw["monkeypatch"].undo()
            calls[side] = rec.calls
            written[side] = wlog.keys
            if files:
                trees[side] = tree_bytes(builtins["tmp_path"])
        assert calls["port"] == calls["jax"], first_difference(
            calls["jax"], calls["port"])
        if files:
            assert trees["port"] == trees["jax"], (
                sorted(trees["jax"]), sorted(trees["port"]))
        if writes:
            assert written["port"] == written["jax"], (
                "writes only by the JAX package: "
                f"{sorted(written['jax'] - written['port'])[:8]}; only by "
                f"the port: {sorted(written['port'] - written['jax'])[:8]}")

    params = [inspect.Parameter("self", inspect.Parameter.POSITIONAL_OR_KEYWORD)
              ] if cls_name is not None else []
    params += [inspect.Parameter(a, inspect.Parameter.KEYWORD_ONLY)
               for a in argnames]
    test.__signature__ = inspect.Signature(params)
    test.__name__ = name
    test.__qualname__ = f"{cls_name or 'mirror'}.{name}"
    return test


def mirror(namespace: dict, ref_name: str, record: Sequence[str] = (),
           select=None, subs: Sequence[Tuple[str, str]] = (),
           files=False, scrub: Sequence[Tuple[str, str]] = (),
           writes: bool = False, drop: Sequence[str] = ()) -> List[str]:
    """Put into `namespace` (a test file's globals) one mirrored test for
    each test case of tests/<ref_name>.py that `select(cls_name, name)`
    keeps (all by default). `files` is a bool or a predicate (cls_name,
    name) -> bool; `writes` compares the two runs' WriteLog sets; `drop`
    names keys and dataclass fields the recorded values leave out. Two
    mirrors of one file into one namespace (with other settings for some
    cases) put their cases of one class into one class. Returns the node
    names mirrored."""
    ref = importlib.import_module(ref_name)
    twin = port_twin(ref_name, subs)
    fx = _fixtures(ref)
    made, classes = [], {}

    def cases():
        for k, v in vars(ref).items():
            if k.startswith("test") and inspect.isfunction(v):
                yield None, k, v
            elif k.startswith("Test") and inspect.isclass(v):
                for m, f in vars(v).items():
                    if m.startswith("test") and inspect.isfunction(f):
                        yield k, m, f

    for cls_name, name, fn in cases():
        if select is not None and not select(cls_name, name):
            continue
        marks = list(getattr(fn, "pytestmark", []))
        if cls_name is not None:
            marks += list(getattr(getattr(ref, cls_name), "pytestmark", []))
        direct = set(_mark_argnames(marks))
        need, seen, stack = [], set(), _argnames(fn)
        for f, (_fn, marker) in fx.items():
            if marker.autouse:
                stack.append(f)
        while stack:
            a = stack.pop(0)
            if a in seen:
                continue
            seen.add(a)
            if a in fx:
                ffn, marker = fx[a]
                if marker.params is not None:
                    marks.append(pytest.mark.parametrize(
                        a, list(marker.params), ids=marker.ids))
                    need.append(a)
                stack += [x for x in _argnames(ffn) if x != "request"]
            elif a in direct:
                need.append(a)
            elif a in BUILTINS:
                need.append(a)
            else:
                raise ValueError(f"{ref_name}::{name}: unknown fixture {a}")
        cmp_files = files(cls_name, name) if callable(files) else files
        if cmp_files and "tmp_path" not in need:
            need.append("tmp_path")
        for b in ("monkeypatch", "caplog"):
            if b not in need:
                need.append(b)
        test = _make_test(ref, twin, cls_name, name, need, record,
                          cmp_files, scrub, writes, drop)
        test.pytestmark = marks
        if cls_name is None:
            namespace[name] = test
            made.append(name)
        else:
            classes.setdefault(cls_name, {})[name] = test
            made.append(f"{cls_name}::{name}")
    for cls_name, meths in classes.items():
        # a class an earlier mirror of the same file made keeps its cases
        prior = namespace.get(cls_name)
        kept = ({k: v for k, v in vars(prior).items() if k.startswith("test")}
                if isinstance(prior, type) else {})
        namespace[cls_name] = type(cls_name, (), {**kept, **meths})
    for k, v in vars(ref).items():
        if k == "pytestmark":
            namespace.setdefault("pytestmark", v)
    return made


# --------------------------------------------------------------------- #
# the helpers' own tests
# --------------------------------------------------------------------- #


def test_norm_makes_records_of_both_packages_equal():
    from kubernetes_tpu.storage import native as jn
    from kubernetes_tpu_torch.storage import native as tn

    assert norm(jn.KVRecord("/k", b"v", 1, 2)) == \
        norm(tn.KVRecord("/k", b"v", 1, 2))
    assert norm(jn.KVRecord("/k", b"v", 1, 2)) != \
        norm(tn.KVRecord("/k", b"v", 1, 3))
    assert norm({"metadata": {"uid": "a", "name": "p"}}) == \
        norm({"metadata": {"uid": "b", "name": "p"}})


def test_port_twin_rebinds_every_import():
    twin = port_twin("test_codec")
    assert twin.codec.__name__ == "kubernetes_tpu_torch.machinery.codec"
    assert twin.APIServer.__module__.startswith("kubernetes_tpu_torch.")


def test_recorder_keeps_outermost_calls_on_its_thread():
    from kubernetes_tpu_torch.machinery import codec

    with Recorder("kubernetes_tpu_torch", ["machinery.codec.encode",
                                           "machinery.codec.decode"]) as rec:
        blob = codec.encode({"a": [1, 2]})
        assert codec.decode(blob) == {"a": [1, 2]}
        t = threading.Thread(target=lambda: codec.encode({"b": 1}))
        t.start()
        t.join()
    assert [c[0] for c in rec.calls] == ["machinery.codec.encode",
                                         "machinery.codec.decode"]
    assert codec.encode.__module__ == "kubernetes_tpu_torch.machinery.codec"
    assert not hasattr(codec.encode, "__wrapped__")


def test_a_difference_between_the_packages_is_caught(monkeypatch):
    """The two runs' recorded calls are equal when both packages return the
    same, and differ as soon as the port returns another value on the same
    call, whatever the case itself asserts."""
    from kubernetes_tpu.machinery import codec as jcodec
    from kubernetes_tpu_torch.machinery import codec as tcodec

    obj = {"z": 1, "a": [True, None, {"β": "ü", "n": -12345}]}

    def run(pkg, codec):
        with Recorder(pkg, ["machinery.codec.encode"]) as rec:
            codec.encode(obj)
        return rec.calls

    assert run("kubernetes_tpu", jcodec) == run("kubernetes_tpu_torch",
                                                 tcodec)
    real = tcodec.encode
    monkeypatch.setattr(tcodec, "encode", lambda o: real(o) + b"\x00")
    a, b = run("kubernetes_tpu", jcodec), run("kubernetes_tpu_torch", tcodec)
    assert a != b and "call 0" in first_difference(a, b)
