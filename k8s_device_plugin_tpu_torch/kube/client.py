"""Minimal Kubernetes REST client: the JAX package's ``kube/client.py``, as
far as the node daemon's kube plane and the scheduler extender's filter/score
plane call it.

It replaces the reference's vendored client-go (controller.go:29-52) with
the surface they need: in-cluster or kubeconfig auth, node get, list and
watch, node annotation, label and condition patches, pod list/watch/get/
annotation patch, Events, and eviction. Built on ``requests`` over the plain
Kubernetes REST API; kubeconfigs are read with PyYAML (so a JSON one
reads too). Watches read with urllib3's ``HTTPResponse.read1``, which
urllib3 has from 2.0: the package's ``requirements.txt`` pins
``urllib3>=2`` and importing this module refuses an older one. The leases,
priority classes, scheduling gates and taints that only the extender's gang
admission, preemption and rescue planes call come with those planes.

Every call is routed through a shared resilience pipeline
(utils/resilience.py): jittered exponential backoff, per-call
deadlines, a retry budget, and a circuit breaker. Transport failures
and 5xx answers are retried and eventually surface as
``UnavailableError`` (an OSError — existing degradation sites catch
it); semantic answers (404/409/410/422/429) propagate immediately as
``KubeError`` because their handling belongs to the caller.

Auth resolution order mirrors client-go's (the reference's
controller.go:29-52: kubeconfig first, else in-cluster):

1. explicit kubeconfig path (flag or $KUBECONFIG),
2. in-cluster service account
   (/var/run/secrets/kubernetes.io/serviceaccount/),
3. explicit base_url (tests / kubectl proxy).
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
import threading
from typing import Dict, Generator, Iterable, Iterator, Optional, Tuple

import requests
import urllib3
import yaml

from ..utils.resilience import Resilience, UnavailableError  # noqa: F401
from ..utils.logging import get_logger
# UnavailableError is re-exported: callers that need to distinguish
# "apiserver unreachable" (degrade/queue) from a semantic KubeError
# import it from here alongside KubeError.

log = get_logger(__name__)


def require_read1(response_cls: type = urllib3.response.HTTPResponse) -> None:
    """Refuse a urllib3 whose responses have no ``read1`` (before 2.0):
    every watch would fail on it and the controller would only see pods at
    each relist."""
    if not hasattr(response_cls, "read1"):
        raise ImportError(
            "kube/client.py needs urllib3>=2 (HTTPResponse.read1), found "
            f"urllib3 {urllib3.__version__}; see the package's requirements.txt"
        )


require_read1()

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

MERGE_PATCH = "application/merge-patch+json"
STRATEGIC_MERGE_PATCH = "application/strategic-merge-patch+json"
JSON_PATCH = "application/json-patch+json"


def rfc3339_now() -> str:
    """UTC timestamp in the second-precision RFC3339 form the API server
    uses for event and condition times."""
    import datetime

    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )


class KubeError(Exception):
    def __init__(
        self,
        status_code: int,
        message: str,
        retry_after_s: Optional[float] = None,
    ):
        super().__init__(f"HTTP {status_code}: {message}")
        self.status_code = status_code
        # Parsed Retry-After header (seconds), when the apiserver sent
        # one (429/503 flow control). The resilience layer raises its
        # backoff floor to honor it instead of hammering a server that
        # just said "not yet".
        self.retry_after_s = retry_after_s


class KubeConfigError(Exception):
    pass


class KubeClient:
    def __init__(
        self,
        base_url: str,
        token: str = "",
        ca_path: Optional[str] = None,
        client_cert: Optional[Tuple[str, str]] = None,
        timeout: float = 10.0,
        resilience: Optional[Resilience] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        # ALL request sites below flow through this retry/backoff/
        # deadline/circuit pipeline (utils/resilience.py); the chaos
        # tests assert no raw unretried site remains. Swappable after
        # construction.
        self.resilience = resilience if resilience is not None else Resilience()
        self._session = requests.Session()
        if token:
            self._session.headers["Authorization"] = f"Bearer {token}"
        self._session.verify = ca_path if ca_path else True
        if base_url.startswith("http://"):
            self._session.verify = False
        if client_cert:
            self._session.cert = client_cert
        # In-flight streaming watch responses, so another thread can
        # abort a blocking read (Controller.stop() must not wait out a
        # 30 s watch window).
        self._watch_lock = threading.Lock()
        self._live_watches: set = set()

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_env(kubeconfig: str = "") -> "KubeClient":
        """kubeconfig (explicit or $KUBECONFIG) first, else in-cluster."""
        path = kubeconfig or os.environ.get("KUBECONFIG", "")
        if path:
            return KubeClient.from_kubeconfig(path)
        return KubeClient.in_cluster()

    @staticmethod
    def in_cluster(sa_dir: str = SERVICE_ACCOUNT_DIR) -> "KubeClient":
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        token_path = os.path.join(sa_dir, "token")
        if not host or not os.path.exists(token_path):
            raise KubeConfigError("not running in a cluster")
        with open(token_path) as f:
            token = f.read().strip()
        ca = os.path.join(sa_dir, "ca.crt")
        return KubeClient(
            f"https://{host}:{port}",
            token=token,
            ca_path=ca if os.path.exists(ca) else None,
        )

    @staticmethod
    def from_kubeconfig(path: str, context: str = "") -> "KubeClient":
        with open(path) as f:
            cfg = yaml.safe_load(f)
        ctx_name = context or cfg.get("current-context", "")
        ctx = _named(cfg.get("contexts", []), ctx_name)
        if ctx is None:
            raise KubeConfigError(f"context {ctx_name!r} not found in {path}")
        cluster = _named(cfg.get("clusters", []), ctx["context"]["cluster"])
        user = _named(cfg.get("users", []), ctx["context"]["user"])
        if cluster is None or user is None:
            raise KubeConfigError(f"incomplete context {ctx_name!r}")
        cl = cluster["cluster"]
        us = user.get("user", {})
        ca_path = cl.get("certificate-authority")
        if not ca_path and cl.get("certificate-authority-data"):
            ca_path = _materialize(cl["certificate-authority-data"], "ca.crt")
        token = us.get("token", "")
        if not token and us.get("tokenFile"):
            with open(us["tokenFile"]) as f:
                token = f.read().strip()
        client_cert = None
        cert, key = us.get("client-certificate"), us.get("client-key")
        if us.get("client-certificate-data") and us.get("client-key-data"):
            cert = _materialize(us["client-certificate-data"], "client.crt")
            key = _materialize(us["client-key-data"], "client.key")
        if cert and key:
            client_cert = (cert, key)
        return KubeClient(
            cl["server"], token=token, ca_path=ca_path, client_cert=client_cert
        )

    # -- raw ---------------------------------------------------------------

    def _attempt(
        self, method: str, path: str, **kw
    ) -> requests.Response:
        """ONE raw HTTP attempt. Never call directly — the resilience
        layer owns retries, backoff, deadlines, and the breaker."""
        kw.setdefault("timeout", self.timeout)
        resp = self._session.request(method, self.base_url + path, **kw)
        if resp.status_code >= 400:
            ra: Optional[float] = None
            header = resp.headers.get("Retry-After", "")
            if header:
                try:
                    ra = max(float(header), 0.0)
                except ValueError:
                    ra = None  # HTTP-date form — rare from kube; skip
            raise KubeError(
                resp.status_code, resp.text[:500], retry_after_s=ra
            )
        return resp

    def _request(
        self,
        method: str,
        path: str,
        verb: str = "",
        deadline_s: Optional[float] = None,
        idempotent: bool = True,
        mutating: bool = False,
        **kw,
    ) -> requests.Response:
        """Resilient request returning the raw Response (streaming
        callers). Retries cover the connect/headers phase; body
        streaming errors are the caller's reconnect loop's job.

        ``idempotent=False`` caps the envelope at ONE attempt (the
        Eviction subresource — a blind retry can double-evict);
        ``mutating=True`` records the call in the resilience tracker's
        mutation ring, the evidence the ``degraded_consistency`` audit
        invariant checks against breaker-open windows."""
        return self.resilience.call(
            lambda: self._attempt(method, path, **kw),
            verb=verb or method,
            deadline_s=deadline_s,
            idempotent=idempotent,
            mutating=mutating,
        )

    def _request_json(
        self,
        method: str,
        path: str,
        verb: str = "",
        deadline_s: Optional[float] = None,
        idempotent: bool = True,
        mutating: bool = False,
        **kw,
    ) -> dict:
        """Resilient request + body parse. The parse happens INSIDE the
        retried closure so a truncated/garbled JSON body (proxy or
        apiserver dying mid-response) is retried like any transport
        failure instead of surfacing as a stray ValueError."""
        return self.resilience.call(
            lambda: self._attempt(method, path, **kw).json(),
            verb=verb or method,
            deadline_s=deadline_s,
            idempotent=idempotent,
            mutating=mutating,
        )

    def get(
        self,
        path: str,
        params: Optional[dict] = None,
        verb: str = "GET",
        deadline_s: Optional[float] = None,
        timeout: Optional[float] = None,
    ) -> dict:
        """``deadline_s``/``timeout`` let latency-contracted callers clamp
        the whole retry envelope AND the single in-flight request below
        their own budget."""
        kw: dict = {"params": params}
        if timeout is not None:
            kw["timeout"] = timeout
        return self._request_json(
            "GET", path, verb=verb, deadline_s=deadline_s, **kw
        )

    def patch(
        self, path: str, body: dict, content_type: str = STRATEGIC_MERGE_PATCH
    ) -> dict:
        # Merge patches are idempotent (applying twice = applying once),
        # so the resilience layer may retry them.
        return self._request_json(
            "PATCH",
            path,
            data=json.dumps(body),
            headers={"Content-Type": content_type},
            mutating=True,
        )

    def create(
        self, path: str, body: dict, idempotent: bool = True
    ) -> dict:
        """POST a new object to a collection path (e.g. ResourceSlices).
        Retried on transport failure: a retry of a create that actually
        landed answers 409, which surfaces to the caller exactly like
        losing a create race — every call site already handles it.
        ``idempotent=False`` (Eviction) forbids the retry: the
        subresource has no such conflict answer, and a blind re-POST
        can evict twice."""
        return self._request_json(
            "POST",
            path,
            data=json.dumps(body),
            headers={"Content-Type": "application/json"},
            idempotent=idempotent,
            mutating=True,
        )

    def replace(self, path: str, body: dict) -> dict:
        """PUT over an existing object path (a ResourceSlice). The body
        carries the object's current resourceVersion, so a PUT that landed
        and is retried answers 409, which makes the retry safe."""
        return self._request_json(
            "PUT",
            path,
            data=json.dumps(body),
            headers={"Content-Type": "application/json"},
            mutating=True,
        )

    def delete(self, path: str) -> dict:
        # Idempotent: a landed-then-retried DELETE answers 404, which
        # every call site already treats as already-gone.
        return self._request_json("DELETE", path, mutating=True)

    # -- nodes -------------------------------------------------------------

    def get_node(self, name: str) -> dict:
        return self.get(f"/api/v1/nodes/{name}")

    def list_nodes(self, label_selector: str = "") -> dict:
        params = {"labelSelector": label_selector} if label_selector else None
        return self.get("/api/v1/nodes", params=params, verb="LIST")

    def patch_node_annotations(
        self, name: str, annotations: Dict[str, Optional[str]]
    ) -> dict:
        """Strategic-merge patch of node annotations, like the reference's
        patchNode (server.go:312-347). None deletes a key."""
        body = {"metadata": {"annotations": annotations}}
        return self.patch(f"/api/v1/nodes/{name}", body)

    def patch_node_labels(
        self, name: str, labels: Dict[str, Optional[str]]
    ) -> dict:
        return self.patch(f"/api/v1/nodes/{name}", {"metadata": {"labels": labels}})

    def patch_node_condition(self, name: str, condition: dict) -> dict:
        """Set one condition in node status (strategic merge keys
        conditions by ``type`` on real API servers) — the
        node-problem-detector pattern for surfacing hardware state to
        cluster tooling without custom annotation scraping."""
        return self.patch(
            f"/api/v1/nodes/{name}/status",
            {"status": {"conditions": [condition]}},
        )

    # -- pods --------------------------------------------------------------

    def list_pods(
        self,
        node_name: str = "",
        namespace: str = "",
        label_selector: str = "",
    ) -> dict:
        path = (
            f"/api/v1/namespaces/{namespace}/pods" if namespace else "/api/v1/pods"
        )
        params: Dict[str, str] = {}
        if node_name:
            params["fieldSelector"] = f"spec.nodeName={node_name}"
        if label_selector:
            params["labelSelector"] = label_selector
        return self.get(path, params=params, verb="LIST")

    def watch_pods(
        self,
        node_name: str = "",
        resource_version: str = "",
        timeout_seconds: int = 60,
        label_selector: str = "",
    ) -> Generator[Tuple[str, dict], None, None]:
        """Yields (event_type, pod) from a single watch window; callers
        reconnect (the informer does). Raises KubeError(410) when the
        resourceVersion is too old — caller must relist."""
        params: Dict[str, str] = {
            "watch": "true",
            "timeoutSeconds": str(timeout_seconds),
            "allowWatchBookmarks": "true",
        }
        if node_name:
            params["fieldSelector"] = f"spec.nodeName={node_name}"
        if label_selector:
            params["labelSelector"] = label_selector
        if resource_version:
            params["resourceVersion"] = resource_version
        return self._watch_stream("/api/v1/pods", params, timeout_seconds)

    def watch_nodes(
        self,
        resource_version: str = "",
        timeout_seconds: int = 60,
    ) -> Generator[Tuple[str, dict], None, None]:
        """Yields (event_type, node) from a single watch window: the
        scheduler extender's topology index consumes it to rebuild exactly
        the node whose annotation changed. Same contract as watch_pods
        (410 means relist)."""
        params: Dict[str, str] = {
            "watch": "true",
            "timeoutSeconds": str(timeout_seconds),
            "allowWatchBookmarks": "true",
        }
        if resource_version:
            params["resourceVersion"] = resource_version
        return self._watch_stream("/api/v1/nodes", params, timeout_seconds)

    def _watch_stream(
        self, path: str, params: Dict[str, str], timeout_seconds: int
    ) -> Generator[Tuple[str, dict], None, None]:
        resp = self._request(
            "GET",
            path,
            verb="WATCH",
            params=params,
            stream=True,
            timeout=timeout_seconds + 10,
        )
        with self._watch_lock:
            self._live_watches.add(resp)
        try:
            truncated = None
            for line in _arriving_lines(resp):
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    # Mid-stream garbage is skippable; remember it so a
                    # stream ENDING on an unparseable line — a partial
                    # frame at connection death — surfaces as the drop
                    # it is instead of a clean window expiry.
                    log.warning("unparseable watch line: %.120r", line)
                    truncated = line
                    continue
                truncated = None
                etype = ev.get("type", "")
                obj = ev.get("object", {})
                if etype == "ERROR":
                    code = obj.get("code", 500)
                    raise KubeError(code, obj.get("message", "watch error"))
                yield etype, obj
            if truncated is not None:
                raise ConnectionError(
                    "watch stream died mid-event (truncated frame)"
                )
        finally:
            with self._watch_lock:
                self._live_watches.discard(resp)
            resp.close()

    def interrupt_watches(self) -> None:
        """Abort any in-flight streaming watch from another thread.

        Closing the response object does NOT wake a thread blocked in a
        socket recv — only shutdown() on the socket itself does. Walk
        down to it (requests Response → urllib3 HTTPResponse ``_fp`` →
        http.client HTTPResponse ``fp`` BufferedReader → SocketIO) and
        shut it down; the blocked ``iter_lines`` then raises immediately
        (ChunkedEncodingError/ConnectionError, library-dependent) in the
        watch-owning thread, which is expected to be shutting down."""
        import socket as socket_mod

        with self._watch_lock:
            watches = list(self._live_watches)
        for resp in watches:
            try:
                sock = resp.raw._fp.fp.raw._sock
                sock.shutdown(socket_mod.SHUT_RDWR)
            except Exception:  # noqa: BLE001 — chain shape varies
                pass
            try:
                if resp.raw is not None:
                    resp.raw.close()
                resp.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    # -- events ------------------------------------------------------------

    def create_event(
        self,
        namespace: str,
        involved_object: dict,
        reason: str,
        message: str,
        event_type: str = "Normal",
        component: str = "nvidia-device-plugin",
    ) -> dict:
        """Emit a core/v1 Event (the reference wires a broadcaster but never
        emits one, controller.go:76-80)."""
        now = rfc3339_now()
        body = {
            "metadata": {"generateName": f"{component}."},
            "involvedObject": involved_object,
            "reason": reason,
            "message": message,
            "type": event_type,
            "source": {"component": component},
            "firstTimestamp": now,
            "lastTimestamp": now,
            "count": 1,
        }
        # Events are additive telemetry: a landed-then-retried POST just
        # double-counts one event — retry stays allowed.
        return self._request_json(
            "POST",
            f"/api/v1/namespaces/{namespace}/events",
            data=json.dumps(body),
            headers={"Content-Type": "application/json"},
            mutating=True,
        )

    def evict_pod(self, namespace: str, name: str) -> dict:
        """Evict a pod via the Eviction subresource, so
        PodDisruptionBudgets are honored (429 = budget blocked, caller
        retries). The subresource exists on every supported API server,
        so a 404 means the pod is already gone — success. 429 and other
        errors propagate as KubeError."""
        body = {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": name, "namespace": namespace},
        }
        try:
            # idempotent=False: ONE attempt, no blind retry — a re-POST
            # of an Eviction that actually landed can evict the pod's
            # replacement. Transport failure surfaces immediately and
            # the journaled preemption/defrag phase aborts-and-replans.
            return self.create(
                f"/api/v1/namespaces/{namespace}/pods/{name}/eviction",
                body,
                idempotent=False,
            )
        except KubeError as e:
            if e.status_code == 404:
                return {}
            raise

    def delete_pod(self, namespace: str, name: str) -> dict:
        """Plain pod delete — the fallback when the Eviction
        subresource cannot serve (e.g. an apiserver build without the
        policy group); unlike evict_pod it does NOT honor
        PodDisruptionBudgets, so callers reach for it only after the
        subresource path failed. A 404 means already gone — success."""
        try:
            return self.delete(f"/api/v1/namespaces/{namespace}/pods/{name}")
        except KubeError as e:
            if e.status_code == 404:
                return {}
            raise

    def patch_pod_annotations(
        self,
        namespace: str,
        name: str,
        annotations: Dict[str, Optional[str]],
    ) -> dict:
        """Pod annotation patch, like the reference's patchPodObject
        (controller.go:227-249)."""
        body = {"metadata": {"annotations": annotations}}
        return self.patch(f"/api/v1/namespaces/{namespace}/pods/{name}", body)

    def get_pod(self, namespace: str, name: str) -> dict:
        return self.get(f"/api/v1/namespaces/{namespace}/pods/{name}")

def _arriving_lines(resp: requests.Response) -> Iterator[bytes]:
    """The lines of a streaming response, each as soon as its newline
    arrives. ``requests``' ``iter_lines`` reads 512 bytes at a time, which
    on a close-delimited (HTTP/1.0) stream holds a small watch event back
    until more data or the window's end; ``read1`` returns what has
    arrived, in either framing. A last line without its newline (a stream
    cut mid-event) is yielded as it is."""
    pending = b""
    while True:
        data = resp.raw.read1(65536)
        if not data:
            break
        *lines, pending = (pending + data).split(b"\n")
        yield from lines
    if pending:
        yield pending


def _named(items: Iterable[dict], name: str) -> Optional[dict]:
    for it in items:
        if it.get("name") == name:
            return it
    return None


def _materialize(b64: str, filename: str) -> str:
    d = tempfile.mkdtemp(prefix="kubecfg-")
    path = os.path.join(d, filename)
    with open(path, "wb") as f:
        f.write(base64.b64decode(b64))
    return path
