"""CRI as a real process boundary: RuntimeService/ImageService over a
Unix-domain socket.

The reference's kubelet↔runtime split is gRPC on a unix socket
(`staging/src/k8s.io/cri-api/pkg/apis/runtime/v1alpha2/api.proto` —
RuntimeService: RunPodSandbox/StopPodSandbox/RemovePodSandbox/
CreateContainer/StartContainer/StopContainer/RemoveContainer/
ContainerStatus/ListPodSandbox/ListContainerStats/Status/Version;
ImageService: ListImages/PullImage/...; wired in
`pkg/kubelet/remote/remote_runtime.go`). grpc/protoc codegen is not
available in this image, so the wire here is length-prefixed JSON frames
(4-byte big-endian size + UTF-8 body) carrying `{"method", "params"}` →
`{"result"}` | `{"error"}` — the same verb set, the same process boundary,
a simpler codec.

Three pieces:

* `CRIServer` — hosts any runtime object with the `FakeCRI` method surface
  behind the socket (thread-per-connection accept loop).
* `RemoteCRI` — the kubelet-side client (`remote_runtime.go` analog): one
  persistent connection, reconnect-once-per-call on failure, raising
  `CRIError` when the runtime is unreachable so the kubelet's sync loops
  degrade instead of dying (fault injection: kill the runtime process, the
  node keeps heartbeating, pods resync when it returns).
* `python -m kubernetes_tpu_torch.kubelet.criserver --socket PATH` — a standalone
  runtime process (the containerd/dockershim seat), so kubelet and runtime
  genuinely live in different processes.

Fake-only verbs, documented as such: `Tick` (drives the PLEG relist clock —
the fake's time wheel) and `SetExitRules` (the containertest-style injection
hook: image-substring → exit-after-seconds), both consumed by the test
harness the way kubemark wires containertest fakes
(`cmd/kubemark/hollow-node.go`).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..kubelet.cri import FakeCRI, FakeContainer, FakeSandbox


class CRIError(RuntimeError):
    """Runtime unreachable or the verb failed server-side (the analog of a
    gRPC transport/status error from remote_runtime.go)."""


# ---------------------------------------------------------------------- #
# framing
# ---------------------------------------------------------------------- #

def _send_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    body = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Dict[str, Any]:
    (size,) = struct.unpack(">I", _recv_exact(sock, 4))
    if size > (64 << 20):
        raise ConnectionError(f"oversized frame: {size}")
    return json.loads(_recv_exact(sock, size))


def _container_wire(c: FakeContainer) -> Dict[str, Any]:
    return {"id": c.id, "name": c.name, "image": c.image,
            "sandboxId": c.sandbox_id, "state": c.state,
            "exitCode": c.exit_code, "startedAt": c.started_at,
            "finishedAt": c.finished_at, "exitAfter": c.exit_after}


def _sandbox_wire(sb: FakeSandbox) -> Dict[str, Any]:
    return {"id": sb.id, "podName": sb.pod_name,
            "podNamespace": sb.pod_namespace, "podUid": sb.pod_uid,
            "ip": sb.ip, "state": sb.state}


# ---------------------------------------------------------------------- #
# server
# ---------------------------------------------------------------------- #

class CRIServer:
    """Serves a runtime (FakeCRI surface) on a unix socket."""

    def __init__(self, runtime: FakeCRI, socket_path: str):
        self.runtime = runtime
        self.socket_path = socket_path
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # verb table: CRI rpc name → handler(params) → result
    def _handle(self, method: str, p: Dict[str, Any]) -> Any:
        rt = self.runtime
        if method == "Version":
            return {"runtimeName": "ktpu-fakecri",
                    "runtimeApiVersion": "v1alpha2",
                    "runtimeVersion": "0.1"}
        if method == "Status":
            return {"conditions": [
                {"type": "RuntimeReady", "status": True},
                {"type": "NetworkReady", "status": True}]}
        if method == "RunPodSandbox":
            return {"podSandboxId": rt.run_pod_sandbox(
                p["podName"], p["podNamespace"], p["podUid"])}
        if method == "StopPodSandbox":
            rt.stop_pod_sandbox(p["podSandboxId"])
            return {}
        if method == "RemovePodSandbox":
            rt.remove_pod_sandbox(p["podSandboxId"])
            return {}
        if method == "ListPodSandbox":
            uid = (p.get("filter") or {}).get("podUid")
            with rt._mu:
                sbs = [_sandbox_wire(sb) for sb in rt.sandboxes.values()
                       if uid is None or sb.pod_uid == uid]
            return {"items": sbs}
        if method == "CreateContainer":
            return {"containerId": rt.create_container(
                p["podSandboxId"], p["name"], p["image"])}
        if method == "StartContainer":
            rt.start_container(p["containerId"])
            return {}
        if method == "StopContainer":
            rt.stop_container(p["containerId"], p.get("exitCode", 137))
            return {}
        if method == "RemoveContainer":
            rt.remove_container(p["containerId"])
            return {}
        if method == "ContainerStatus":
            c = rt.container_status(p["containerId"])
            return {"status": _container_wire(c) if c is not None else None}
        if method == "ListImages":
            return {"images": rt.list_images()}
        if method == "PullImage":
            rt.pull_image(p["image"])
            return {}
        if method == "RemoveImage":
            rt.remove_image(p["image"])
            return {}
        if method == "ImageFsInfo":
            return rt.image_fs_info()
        if method == "ListContainerStats":
            return {"stats": rt.list_stats()}
        if method == "Probe":  # the prober's check, policy-backed (fake)
            return {"ok": rt.probe(p["containerId"], p["kind"])}
        if method == "Tick":  # fake-only: PLEG relist clock
            return {"changed": rt.tick()}
        if method == "SetExitRules":  # fake-only: containertest injection
            rules: List[Tuple[str, float]] = [
                (r[0], float(r[1])) for r in p.get("rules", [])]

            def policy(image: str) -> Optional[float]:
                for substr, secs in rules:
                    if substr in image:
                        return secs
                return None

            rt.exit_policy = policy
            return {}
        raise CRIError(f"unimplemented verb: {method}")

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                req = _recv_frame(conn)
                try:
                    result = self._handle(req.get("method", ""),
                                          req.get("params", {}) or {})
                    _send_frame(conn, {"result": result})
                except (ConnectionError, BrokenPipeError):
                    raise
                except Exception as e:  # noqa: BLE001 — verb errors go on
                    # the wire as status, the transport stays up (gRPC status
                    # vs transport failure)
                    _send_frame(conn, {"error": f"{type(e).__name__}: {e}"})
        except (ConnectionError, OSError, json.JSONDecodeError):
            pass
        finally:
            conn.close()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="cri-conn")
            t.start()
            self._threads.append(t)

    def start(self) -> "CRIServer":
        try:
            os.unlink(self.socket_path)
        except FileNotFoundError:
            pass
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(64)
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="cri-accept")
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass


# ---------------------------------------------------------------------- #
# client (kubelet side)
# ---------------------------------------------------------------------- #

class RemoteCRI:
    """Duck-type drop-in for FakeCRI that dials the socket per verb —
    `pkg/kubelet/remote/remote_runtime.go`'s seat. One persistent
    connection under a lock; one reconnect attempt per call."""

    def __init__(self, socket_path: str, timeout: float = 5.0):
        self.socket_path = socket_path
        self.timeout = timeout
        self._mu = threading.Lock()
        self._conn: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        s.connect(self.socket_path)
        return s

    def _call(self, method: str, **params: Any) -> Any:
        req = {"method": method, "params": params}
        with self._mu:
            for attempt in (0, 1):
                fresh = sent = False
                try:
                    if self._conn is None:
                        self._conn = self._connect()
                        fresh = True
                    _send_frame(self._conn, req)
                    sent = True
                    resp = _recv_frame(self._conn)
                    break
                except (OSError, ConnectionError, json.JSONDecodeError) as e:
                    if self._conn is not None:
                        try:
                            self._conn.close()
                        except OSError:
                            pass
                        self._conn = None
                    # at-most-once: retransmit ONLY when the request cannot
                    # have reached the runtime — a stale reused connection
                    # failing at send time. A failure after a successful
                    # send (recv/timeout) may have executed server-side;
                    # resending RunPodSandbox/CreateContainer there would
                    # duplicate sandboxes (gRPC semantics: transport retry,
                    # never application retry).
                    if sent or fresh or attempt:
                        raise CRIError(
                            f"runtime unreachable at {self.socket_path}: {e}")
        if "error" in resp:
            raise CRIError(resp["error"])
        return resp.get("result")

    def close(self) -> None:
        with self._mu:
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None

    # -- FakeCRI method surface ------------------------------------------ #

    def run_pod_sandbox(self, pod_name: str, pod_namespace: str,
                        pod_uid: str) -> str:
        return self._call("RunPodSandbox", podName=pod_name,
                          podNamespace=pod_namespace,
                          podUid=pod_uid)["podSandboxId"]

    def stop_pod_sandbox(self, sid: str) -> None:
        self._call("StopPodSandbox", podSandboxId=sid)

    def remove_pod_sandbox(self, sid: str) -> None:
        self._call("RemovePodSandbox", podSandboxId=sid)

    def create_container(self, sid: str, name: str, image: str) -> str:
        return self._call("CreateContainer", podSandboxId=sid, name=name,
                          image=image)["containerId"]

    def start_container(self, cid: str) -> None:
        self._call("StartContainer", containerId=cid)

    def stop_container(self, cid: str, exit_code: int = 137) -> None:
        self._call("StopContainer", containerId=cid, exitCode=exit_code)

    def remove_container(self, cid: str) -> None:
        self._call("RemoveContainer", containerId=cid)

    def container_status(self, cid: str) -> Optional[FakeContainer]:
        w = self._call("ContainerStatus", containerId=cid)["status"]
        if w is None:
            return None
        return FakeContainer(
            id=w["id"], name=w["name"], image=w["image"],
            sandbox_id=w["sandboxId"], state=w["state"],
            exit_code=w["exitCode"], started_at=w["startedAt"],
            finished_at=w["finishedAt"], exit_after=w["exitAfter"])

    def sandbox_for_pod(self, pod_uid: str) -> Optional[FakeSandbox]:
        items = self._call("ListPodSandbox",
                           filter={"podUid": pod_uid})["items"]
        for w in items:
            if w["state"] == "SANDBOX_READY":
                return FakeSandbox(
                    id=w["id"], pod_name=w["podName"],
                    pod_namespace=w["podNamespace"], pod_uid=w["podUid"],
                    ip=w["ip"], state=w["state"])
        return None

    def tick(self) -> List[str]:
        return self._call("Tick")["changed"]

    def list_stats(self) -> List[Dict[str, Any]]:
        return self._call("ListContainerStats")["stats"]

    def probe(self, cid: str, kind: str) -> bool:
        return self._call("Probe", containerId=cid, kind=kind)["ok"]

    def version(self) -> Dict[str, Any]:
        return self._call("Version")

    # -- ImageService -------------------------------------------------- #

    def pull_image(self, image: str) -> None:
        self._call("PullImage", image=image)

    def list_images(self) -> List[Dict[str, Any]]:
        return self._call("ListImages")["images"]

    def remove_image(self, image: str) -> None:
        self._call("RemoveImage", image=image)

    def image_fs_info(self) -> Dict[str, Any]:
        return self._call("ImageFsInfo")

    def set_exit_rules(self, rules: List[Tuple[str, float]]) -> None:
        self._call("SetExitRules", rules=[list(r) for r in rules])


def main(argv: Optional[List[str]] = None) -> None:
    """Standalone runtime process: the containerd seat on the other side of
    the boundary."""
    ap = argparse.ArgumentParser(prog="ktpu-cri-runtime")
    ap.add_argument("--socket", required=True)
    ap.add_argument("--exit-rule", action="append", default=[],
                    metavar="SUBSTR=SECONDS",
                    help="containers whose image contains SUBSTR exit 0 "
                         "after SECONDS")
    args = ap.parse_args(argv)
    rt = FakeCRI()
    rules = []
    for r in args.exit_rule:
        substr, _, secs = r.partition("=")
        rules.append((substr, float(secs)))
    if rules:
        rt.exit_policy = lambda image: next(
            (s for sub, s in rules if sub in image), None)
    srv = CRIServer(rt, args.socket).start()
    stop = threading.Event()
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()


if __name__ == "__main__":
    main()
