"""Device-native KV page handoff (the port's copy of the JAX package's
``fleet/device_transfer.py``): arena-to-arena page movement between
co-located prefill and decode replicas, with no host copy.

The wire path (``fleet/handoff.py``) moves every page through a copy to
the host, a numpy serialization, an HTTP frame and a copy back to the
card. This module is the ladder above it:

- **Placement domains.** Every replica advertises a *placement domain*
  (``detect_placement_domain``): replicas in the same domain can hand
  pages to each other without the wire. The auto-detected domain is
  ``proc:<host>:<pid>``, the co-location the in-process bus can prove.
  Operators override it per pool (``TPU_FLEET_PLACEMENT_DOMAIN`` or
  ``--placement-domain``); a claim the bus cannot back downgrades, so the
  ladder is device -> shm -> wire -> the router's unified fallback,
  never an error the client sees.

- **DeviceTransferBus.** A process-local registry from a replica's
  advertise URL to its live engine and domain. ``serve_main`` registers
  its engine at startup; the prefill side's ``device_push`` looks the
  decode replica up by the SAME URL the router hands it for the wire
  push, so the two paths are interchangeable per hop.

- **device_push.** The prefill half: a hop to an engine of this process
  (two engines on one card) runs ``export_handoff_device`` ->
  ``adopt_handoff_device`` (monolithic) or ``export_handoff_stream``
  feeding ``adopt_handoff_chunk_device`` fragments through the decode
  engine's ``HandoffStreamAssembler`` (streamed). The pages stay tensors
  on the card end to end: the exporter's ``index_select`` makes fresh
  copies, the adopter's ``index_copy_`` writes them into its arena once it
  has waited on the exporter's event, and refcounts move only after the
  adoption lands — the all-or-nothing contract of the wire path.

- **The shm rung.** Two replicas in one domain but different processes
  cannot use the bus: the run rides a wire-codec blob through a tmpfs
  file (``write_shm_blob``/``open_shm_blob``), and only its path crosses
  the socket. Cross-process CUDA IPC has no counterpart in the JAX
  package and is no rung here.

Any failure raises ``DeviceTransferError`` (or the engine's
HandoffError); the caller (``serve_main``'s /kv_prefill) counts a
downgrade and falls back to the wire codec unchanged.

Stdlib only: the engines it moves pages between do the tensor work.
"""

from __future__ import annotations

import json as _json
import logging
import mmap
import os
import socket
import tempfile
import threading
import time
import urllib.request
import uuid
from typing import Callable, Optional

log = logging.getLogger(__name__)


class DeviceTransferError(RuntimeError):
    """A device-path hop that cannot proceed (no bus entry, domain
    mismatch, dead peer). The caller downgrades to the wire codec — this
    is a routing downgrade, never a request failure."""


def detect_placement_domain(override: str = "",
                            env: Optional[dict] = None,
                            mode: str = "auto") -> str:
    """This replica's placement domain: explicit override first (flag >
    TPU_FLEET_PLACEMENT_DOMAIN env), then — in ``auto``/``slice`` mode —
    a SLICE-scoped domain derived from the gang metadata the
    kubelet's gang scheduler stamps on members (``TPU_SLICE_NAME``, the
    same identity gang/env.py renders into the workers' env), else
    ``proc:<host>:<pid>``, the co-location the in-process bus can serve
    with zero configuration. The slice domain is HOST-qualified
    (``slice:<name>:<host>``) because the cross-process rung moves blobs
    through a tmpfs file two processes mmap — same-kernel reachability,
    which a multi-host slice does not give; operators with a real
    inter-host ICI transport override the domain explicitly and take
    responsibility for the claim. ``mode="proc"`` pins one process per
    domain. Two replicas with EQUAL non-empty
    domains are device-reachable; everything else rides the wire."""
    if override:
        return override
    env = os.environ if env is None else env
    from_env = env.get("TPU_FLEET_PLACEMENT_DOMAIN", "")
    if from_env:
        return from_env
    if mode in ("auto", "slice"):
        slice_name = env.get("TPU_SLICE_NAME", "")
        if slice_name:
            return f"slice:{slice_name}:{socket.gethostname()}"
        if mode == "slice":
            log.warning("placement-domain mode 'slice' but TPU_SLICE_NAME "
                        "is unset — falling back to the process domain")
    return f"proc:{socket.gethostname()}:{os.getpid()}"


class DeviceTransferBus:
    """Process-local advertise-URL -> (engine, domain) registry. Thread
    safe (handler threads race registration against lookups); entries are
    overwritten on re-registration (a restarted engine under the same
    URL wins)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, tuple[object, str]] = {}

    @staticmethod
    def _key(url: str) -> str:
        return (url or "").rstrip("/")

    def register(self, url: str, engine, domain: str) -> None:
        if not url or not domain:
            raise ValueError("device bus registration needs a URL and a "
                             "placement domain")
        with self._lock:
            self._entries[self._key(url)] = (engine, domain)

    def unregister(self, url: str) -> None:
        with self._lock:
            self._entries.pop(self._key(url), None)

    def lookup(self, url: str) -> Optional[tuple[object, str]]:
        with self._lock:
            return self._entries.get(self._key(url))

    def clear(self) -> None:
        """Test hook: the bus is process-global, suites must not leak
        engines between cases."""
        with self._lock:
            self._entries.clear()


# the process-wide bus: serve_main registers engines here; tests register
# theirs directly and clear() between cases
BUS = DeviceTransferBus()


# -- cross-process same-host rung ---------------------------------------------
#
# Two replicas in one placement domain but DIFFERENT processes cannot use
# the bus (it holds live engine references). The rung between "same
# process" and "wire" is a handoff-codec blob through a tmpfs file:
# the sender writes the serialized run into /dev/shm, the receiver mmaps
# it and adopts through deserialize_pages UNCHANGED (the codec's
# validators work on any buffer — an mmap slices like bytes). No socket
# ever carries the page payload, the receiver's numpy views alias the
# mapped file (zero copies until the arena scatter), and the ladder's
# discipline holds: any failure — missing file, foreign host, torn write,
# refused adoption — downgrades to the wire codec.

_SHM_PREFIX = "tpukv-"


def shm_dir() -> str:
    """Where cross-process blobs live: the kernel tmpfs when the host has
    one (Linux — file bytes stay in page cache, never touch disk), else
    the tmp dir (the rung still works, just through filesystem cache)."""
    d = "/dev/shm"
    return d if os.path.isdir(d) else tempfile.gettempdir()


def write_shm_blob(blob: bytes, dir: Optional[str] = None) -> str:
    """Write one handoff blob to a fresh private file in the shm dir and
    return its path. mkstemp gives an unguessable name with 0600 modes —
    a peer learns the path only from the sender's POST."""
    fd, path = tempfile.mkstemp(prefix=_SHM_PREFIX, suffix=".kv",
                                dir=dir or shm_dir())
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
    except OSError:
        try:
            os.unlink(path)
        except OSError:
            pass
        raise
    return path


def open_shm_blob(path: str, dir: Optional[str] = None) -> mmap.mmap:
    """mmap a peer-written blob read-only. The path is VALIDATED into the
    shm dir with the tpukv- prefix first: the /kv_adopt_shm and /kv_pull
    doors take paths from the network, and without the check they would
    be an open-any-file oracle. Raises DeviceTransferError on a path
    outside the shm dir or a file that cannot map (vanished, torn,
    empty) — the caller downgrades to wire."""
    base = os.path.realpath(dir or shm_dir())
    real = os.path.realpath(str(path or ""))
    if os.path.dirname(real) != base \
            or not os.path.basename(real).startswith(_SHM_PREFIX):
        raise DeviceTransferError(
            f"refusing KV blob path outside {base!r}: {path!r}")
    try:
        with open(real, "rb") as f:
            return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except (OSError, ValueError) as e:
        # ValueError = empty file (a torn writer); both downgrade
        raise DeviceTransferError(f"cannot map KV blob {path!r}: {e}") from e


class ShmBlobGC:
    """Owner-side lifecycle for PULL blobs. On the pull path the OWNER
    writes the file and the PULLER unlinks it after adoption (unlink by
    a non-creator is exactly what tmpfs files allow); a puller that dies
    mid-pull would leak the file forever, so the owner tracks what it
    wrote and sweeps anything older than ``ttl_s`` on its next /kv_pull.
    Push-path blobs never come through here — the sender unlinks its own
    file synchronously in a finally. Clock-injected; unlink races with
    the puller are benign (ENOENT = the success path already cleaned
    up)."""

    def __init__(self, ttl_s: float = 120.0,
                 clock: Callable[[], float] = time.monotonic):
        if ttl_s <= 0:
            raise ValueError("ttl_s must be > 0")
        self.ttl_s = ttl_s
        self.clock = clock
        self._lock = threading.Lock()
        self._files: dict[str, float] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._files)

    def track(self, path: str) -> None:
        with self._lock:
            self._files[path] = self.clock()

    def sweep(self) -> int:
        """Unlink expired blobs; returns how many files actually died
        (a puller-side unlink already having happened is not a leak)."""
        now = self.clock()
        with self._lock:
            expired = [p for p, t in self._files.items()
                       if now - t > self.ttl_s]
            for p in expired:
                del self._files[p]
        n = 0
        for p in expired:
            try:
                os.unlink(p)
                n += 1
            except OSError:
                pass  # the puller unlinked it — the success path
        return n


def _post_json(url: str, payload: dict, timeout_s: float,
               headers: Optional[dict] = None) -> dict:
    """One small JSON POST for the shm control messages (the DATA never
    rides HTTP on this rung — only the path crosses the socket)."""
    req = urllib.request.Request(
        url, data=_json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        raw = resp.read()
    out = _json.loads(raw) if raw else {}
    return out if isinstance(out, dict) else {}


def shm_push(engine, target_url: str, tokens: list, *,
             timeout_s: float = 30.0, dir: Optional[str] = None,
             headers: Optional[dict] = None) -> dict:
    """The cross-process rung of a PUSH hop: export the run through the
    wire codec, park the blob in tmpfs, and hand the target only its
    path (POST /kv_adopt_shm). The target mmaps + adopts with the same
    deserialize_pages validation the wire door runs; the sender unlinks
    the file SYNCHRONOUSLY whether or not adoption landed — the push
    rung never leaves a blob for GC to find. Raises DeviceTransferError
    (caller downgrades to wire) on any refusal."""
    out = engine.export_handoff(tokens)
    blob = out["blob"]
    path = write_shm_blob(blob, dir)
    try:
        try:
            reply = _post_json(target_url.rstrip("/") + "/kv_adopt_shm",
                               {"path": path}, timeout_s, headers)
        except OSError as e:
            raise DeviceTransferError(
                f"shm adoption POST to {target_url!r} failed: {e}") from e
        if not reply.get("ok"):
            raise DeviceTransferError(
                f"shm adoption refused by {target_url!r}: {reply}")
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass
    return {"pages": out["pages"], "bytes": len(blob),
            "covered_tokens": out["covered_tokens"],
            "matched_tokens": out["matched_tokens"],
            "streamed": False, "adopted": reply.get("pages"),
            "path": "shm"}


def device_pull(engine, owner_url: str, tokens: list, *,
                adapter: str = "", domain: str,
                bus: Optional[DeviceTransferBus] = None) -> dict:
    """Device-local rung of a PULL hop: the cold replica
    (``engine``) fetches an already-computed page run from the owning
    replica — both in ONE process, resolved on the bus — with zero
    serialization: the owner's export_pull_device copies the run's pages
    on the card (match-only, it never prefills) and this engine adopts
    them through check_device_sections once it has waited on the owner's
    event. KVPullMiss propagates untouched (the owner's
    trie no longer holds the run — every other rung would miss the same
    way, so the caller reports GONE instead of walking the ladder);
    transport-shaped failures raise DeviceTransferError and the caller
    downgrades to the shm/wire pull."""
    bus = bus or BUS
    entry = bus.lookup(owner_url)
    if entry is None:
        raise DeviceTransferError(
            f"no device-reachable engine registered at {owner_url!r} "
            "(bus miss — owner in another process)")
    owner, owner_domain = entry
    if not domain or owner_domain != domain:
        raise DeviceTransferError(
            f"placement-domain mismatch: this replica is in {domain!r}, "
            f"owner {owner_url!r} advertises {owner_domain!r}")
    out = owner.export_pull_device(tokens, adapter=adapter)
    adopted = engine.adopt_handoff_device(out["tokens"], out["sections"],
                                          model=out["model"],
                                          adapter=adapter,
                                          ready=out["ready"])
    return {"pages": out["pages"], "bytes": adopted["bytes"],
            "covered_tokens": out["covered_tokens"], "path": "device"}


def _streamed_device_push(engine, peer, tokens: list, model: str,
                          window: int) -> dict:
    """The chunked leg of device_push: export_handoff_stream's fragments
    cross to the peer's assembler on a SENDER THREAD behind a bounded
    queue — the same compute/transfer decoupling the wire path's
    serve_main sender has. Adoption takes the PEER's handoff/prefix
    locks (its own steps hold them through their launches), so running it
    inline in ``emit`` would stall the prefill compute thread mid-hop and
    give back the overlap the stream exists for; the queue bounds
    fragments in flight exactly like handoff_stream_window does for wire
    frames (fragments pin fresh copies on the card, so the bound is
    device memory, not host memory)."""
    import queue as _q

    stream_id = uuid.uuid4().hex
    sendq: "_q.Queue" = _q.Queue(maxsize=max(1, int(window)))
    stats = {"frames": 0, "bytes": 0, "result": None}
    push_err: list = []

    def sender():
        while True:
            frag = sendq.get()
            if frag is None:
                return
            try:
                if frag["final"]:
                    out = peer.adopt_handoff_chunk_device(
                        stream_id, frag["seq"], [], {}, final=True,
                        total_tokens=frag["total_tokens"], model=model)
                else:
                    out = peer.adopt_handoff_chunk_device(
                        stream_id, frag["seq"], frag["tokens"],
                        frag["sections"], model=model, ready=frag["ready"])
                stats["frames"] += 1
                stats["bytes"] += int(out.get("bytes") or 0)
                if out.get("final"):
                    stats["result"] = out
            except Exception as e:  # noqa: BLE001 — any adoption failure
                # aborts the hop; emit sees push_err and stops the export
                push_err.append(e)
                return

    thread = threading.Thread(target=sender, name="kv-device-sender",
                              daemon=True)

    def emit(frag):
        while True:
            if push_err:
                raise DeviceTransferError(
                    f"device stream adoption failed: {push_err[0]}")
            try:
                sendq.put(frag, timeout=0.1)
                return
            except _q.Full:
                continue

    def finish(abort: bool):
        """Land the close sentinel unconditionally (a stranded sender
        would leak a thread per failed hop) — drain stale fragments on
        abort, wait for slots on success (serve_main's finish_sender
        discipline)."""
        if not abort:
            while not push_err:
                try:
                    sendq.put(None, timeout=0.1)
                    thread.join(timeout=120.0)
                    return
                except _q.Full:
                    continue
        while True:
            try:
                sendq.get_nowait()
            except _q.Empty:
                break
        sendq.put(None)
        thread.join(timeout=120.0)

    thread.start()
    try:
        out = engine.export_handoff_stream(tokens, emit)
    except Exception:
        finish(abort=True)
        raise
    finish(abort=False)
    adopted = stats["result"]
    if push_err or adopted is None:
        # the export closed without the peer confirming adoption —
        # treat exactly like an unconfirmed wire push
        raise DeviceTransferError(
            f"device stream closed without a final adoption"
            f"{f': {push_err[0]}' if push_err else ''}")
    # sender-side device accounting (the catalogue's 'sender counts
    # exports': export_handoff_stream is path-agnostic, so the device
    # series moves HERE for streamed hops, mirroring
    # export_handoff_device on the monolithic leg)
    engine.metrics.incr("tpu_serving_kv_handoff_device_runs")
    engine.metrics.incr("tpu_serving_kv_handoff_device_bytes",
                        adopted["bytes"])
    return {"pages": out["pages"], "chunks": out["chunks"],
            "frames": stats["frames"], "bytes": adopted["bytes"],
            "covered_tokens": out["covered_tokens"],
            "matched_tokens": out["matched_tokens"],
            "streamed": True, "adopted": adopted["pages"],
            "path": "device"}


def device_push(engine, target_url: str, tokens: list, *,
                domain: str, bus: Optional[DeviceTransferBus] = None,
                window: int = 8, target_domain: str = "",
                timeout_s: float = 30.0,
                headers: Optional[dict] = None) -> dict:
    """Prefill half of a DEVICE-path handoff: resolve the decode replica
    on the bus, verify co-location, and move the prompt's page run
    arena-to-arena with no serialization. Chunked engines
    (serving_chunk_tokens > 0) stream per-chunk device fragments through
    the decode engine's assembler (strict seq, all-or-nothing adoption)
    with a sender thread overlapping adoption under the next chunk's
    compute (``window`` bounds fragments in flight — serve_main passes
    its handoff_stream_window); monolithic engines move the whole run in
    one export/adopt pair.

    A bus MISS is not the end of the device tier: when
    the router vouched the target shares this domain (``target_domain``,
    from its registration data) the hop takes the cross-process shm rung
    — blob through tmpfs, mmap on the far side, zero socket payload.
    Chunked engines skip that rung (a file is inherently monolithic;
    their wire STREAMING overlaps compute with transfer, which the shm
    file cannot) — the full ladder is device-local → shm → wire →
    unified.

    Returns the same shape as the wire hop's reply ({"pages", "bytes",
    "covered_tokens", "matched_tokens"} + streamed/chunks when chunked)
    with ``path: "device"`` (or ``"shm"``). Raises DeviceTransferError
    when the target is not device-reachable (caller downgrades to wire)
    and lets engine HandoffErrors propagate (caller downgrades too —
    mismatched geometry or a failed adoption must not kill the
    request)."""
    bus = bus or BUS
    entry = bus.lookup(target_url)
    if entry is None:
        if domain and target_domain == domain \
                and engine.sc.serving_chunk_tokens <= 0:
            return shm_push(engine, target_url, tokens,
                            timeout_s=timeout_s, headers=headers)
        raise DeviceTransferError(
            f"no device-reachable engine registered at {target_url!r} "
            "(bus miss — replica in another process or not registered"
            + (", streamed hops ride the wire" if domain
               and target_domain == domain else "") + ")")
    peer, peer_domain = entry
    if not domain or peer_domain != domain:
        raise DeviceTransferError(
            f"placement-domain mismatch: this replica is in {domain!r}, "
            f"{target_url!r} advertises {peer_domain!r}")
    model = engine.cfg.name
    if engine.sc.serving_chunk_tokens > 0:
        return _streamed_device_push(engine, peer, tokens, model, window)
    out = engine.export_handoff_device(tokens)
    adopted = peer.adopt_handoff_device(out["tokens"], out["sections"],
                                        model=model, ready=out["ready"])
    return {"pages": out["pages"], "bytes": adopted["bytes"],
            "covered_tokens": out["covered_tokens"],
            "matched_tokens": out["matched_tokens"],
            "streamed": False, "adopted": adopted["pages"],
            "path": "device"}
