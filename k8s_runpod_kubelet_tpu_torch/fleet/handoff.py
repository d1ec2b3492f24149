"""KV page-run handoff codec (the port's copy of the JAX package's
``fleet/handoff.py``): the wire format between a prefill replica's arena
and a decode replica's.

A handoff moves the KV of a prompt's FULL pages — exactly what the paged
prefix pool already treats as the shareable unit — from the replica that
computed them to the replica that will decode against them. The decode
side adopts the pages into its own arena through the prefix trie, so the
engine's normal prompt match then references them zero-copy and only the
sub-page tail recomputes.

Wire format (one blob, streamable over the existing HTTP surface), byte
for byte the JAX package's, so a blob from either package adopts into the
other:

    MAGIC(6) | u32 header_len | header JSON | section payloads

The header carries ``version``, ``page_tokens``, ``n_pages``, the token
ids the pages cover (the trie key — adoption is meaningless without
them), and per-section name/dtype/shape/byte-length. Section payloads
follow in header order as C-contiguous bytes. The codec is generic over
the section dict, so plain K/V, int8-KV (scales page alongside) and MLA
latent layouts (with a dense prefix's ``_pre`` sections) all serialize
through the same two functions — layout differences are just different
section names/shapes, validated on the receiving side against the
adopting arena.

Validation is deliberately paranoid: a truncated stream, a bad magic, a
future version, a page-size or dtype mismatch each raise a typed
``HandoffError`` — the router treats any of them as a failed handoff and
falls back, never half-adopting KV.

numpy-only on purpose (no torch import): the codec must be usable by
tests and tools without a device runtime. numpy has no bfloat16, and the
port does not lean on ``ml_dtypes``: a bfloat16 section travels as its
raw 2-byte words (a ``uint16`` array) under the dtype name "bfloat16"
(``serialize_pages``' ``dtypes``), and ``deserialize_pages`` hands such a
section back as ``uint16`` words. The adopter views them as
``torch.bfloat16``; nothing rounds through another type, so the bytes on
the wire are the arena's bytes.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

import numpy as np

MAGIC = b"TPUKV\x01"
VERSION = 1
# streaming handoff : sequence-numbered CHUNK FRAMES, each
# wrapping one page-run blob, pushed while the next prefill chunk is
# still computing. Distinct magic so a whole-run blob can never be fed
# to the stream path (or vice versa) silently.
CHUNK_MAGIC = b"TPUKC\x01"
CHUNK_VERSION = 1
# refuse absurd headers before json.loads touches them (a corrupt length
# prefix must not allocate gigabytes)
_MAX_HEADER_BYTES = 16 * 1024 * 1024


class HandoffError(ValueError):
    """A KV handoff blob that must not be adopted (truncated, foreign
    version, or shaped for a different arena). Callers treat it as a
    failed handoff and fall back to a full prefill."""


class KVPullMiss(HandoffError):
    """A /kv_pull export found the owner's trie no longer holds the
    requested page run (evicted since the directory publish). The door
    answers 404 {"gone": true}; the router invalidates the directory
    entry and the puller falls back to prefill — one miss, no retry."""


# dtypes numpy lacks, each carried as raw words of its width
_WORDS = {"bfloat16": np.dtype(np.uint16)}


def _dtype(name: str) -> np.dtype:
    """The numpy dtype a section of dtype ``name`` is held in: the words
    of ``_WORDS`` for a dtype numpy lacks, else numpy's own (TypeError for
    a name numpy does not know)."""
    if name in _WORDS:
        return _WORDS[name]
    return np.dtype(name)


def _dtype_name(name: str) -> str:
    """The canonical name of dtype ``name`` ("f4" -> "float32")."""
    return name if name in _WORDS else np.dtype(name).name


def dtype_name(dtype) -> str:
    """The wire name of a numpy or torch dtype: numpy's name, torch's
    without its ``torch.`` prefix ("bfloat16", "float32", "int8")."""
    name = getattr(dtype, "name", None)
    return name if isinstance(name, str) else str(dtype).removeprefix(
        "torch.")


def serialize_pages(tokens: list, page_tokens: int,
                    sections: dict[str, np.ndarray],
                    model: str = "",
                    dtypes: Optional[dict[str, str]] = None) -> bytes:
    """Pack a page run into one blob. ``sections[name]`` is the page
    payload for one arena section, shaped ``(L, n_pages, page_tokens,
    ...)`` — i.e. the arena section sliced to the run's page ids, in
    prompt order. ``tokens`` are the token ids those pages hold
    (``n_pages * page_tokens`` of them). ``dtypes[name]`` names the dtype
    a section's raw words carry when numpy has no such dtype (a bfloat16
    section as ``uint16`` words under "bfloat16")."""
    if not sections:
        raise HandoffError("no sections to serialize")
    n_pages = next(iter(sections.values())).shape[1]
    if len(tokens) != n_pages * page_tokens:
        raise HandoffError(
            f"token count {len(tokens)} != n_pages {n_pages} * "
            f"page_tokens {page_tokens}")
    metas = []
    payloads = []
    for name, arr in sections.items():
        arr = np.ascontiguousarray(arr)
        if arr.ndim < 3 or arr.shape[1] != n_pages \
                or arr.shape[2] != page_tokens:
            raise HandoffError(
                f"section {name!r} shape {arr.shape} is not "
                f"(L, {n_pages}, {page_tokens}, ...)")
        dname = (dtypes or {}).get(name) or arr.dtype.name
        if _dtype(dname).itemsize != arr.dtype.itemsize:
            raise HandoffError(
                f"section {name!r}: {arr.dtype.name} words cannot carry "
                f"{dname}")
        raw = arr.tobytes()
        metas.append({"name": name, "dtype": dname,
                      "shape": list(arr.shape), "bytes": len(raw)})
        payloads.append(raw)
    header = json.dumps({
        "version": VERSION, "page_tokens": page_tokens, "n_pages": n_pages,
        "tokens": [int(t) for t in tokens], "model": model,
        "sections": metas}).encode()
    return b"".join([MAGIC, len(header).to_bytes(4, "big"), header]
                    + payloads)


def deserialize_pages(blob: bytes, *,
                      expect_page_tokens: Optional[int] = None,
                      expect_sections: Optional[dict] = None,
                      expect_model: Optional[str] = None
                      ) -> tuple[dict, dict[str, np.ndarray]]:
    """Unpack a handoff blob into (header dict, {name: array}).

    ``expect_page_tokens`` rejects a run paged at a different granule
    (the pages could not be re-chunked without re-deriving positions);
    ``expect_sections`` maps section name -> (dtype name, per-page
    trailing shape) — the adopting arena's layout — and rejects missing/
    extra sections, dtype mismatches, and trailing-shape mismatches.
    ``expect_model`` rejects KV computed by a DIFFERENT model whose
    arena geometry happens to match (e.g. two checkpoints of one
    architecture during a rollout) — adopting it would serve garbage
    completions with no error, and the poisoned pages would stay cached.
    Every failure mode raises HandoffError with the reason. A section of
    a dtype numpy lacks comes back as its raw words (bfloat16 as
    ``uint16``); the header's section metas name its dtype."""
    if len(blob) < len(MAGIC) + 4:
        raise HandoffError(f"truncated blob: {len(blob)} bytes is shorter "
                           "than the fixed header")
    if blob[:len(MAGIC)] != MAGIC:
        raise HandoffError("bad magic: not a KV handoff blob")
    hlen = int.from_bytes(blob[len(MAGIC):len(MAGIC) + 4], "big")
    if hlen > _MAX_HEADER_BYTES:
        raise HandoffError(f"header length {hlen} exceeds sanity cap")
    off = len(MAGIC) + 4
    if len(blob) < off + hlen:
        raise HandoffError(f"truncated header: need {hlen} bytes, "
                           f"have {len(blob) - off}")
    try:
        header = json.loads(blob[off:off + hlen])
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise HandoffError(f"unparseable header: {e}") from e
    off += hlen
    if not isinstance(header, dict):
        raise HandoffError("header is not an object")
    version = header.get("version")
    if version != VERSION:
        raise HandoffError(f"version {version!r} not supported "
                           f"(this build speaks {VERSION})")
    page_tokens = header.get("page_tokens")
    n_pages = header.get("n_pages")
    tokens = header.get("tokens")
    metas = header.get("sections")
    if not (isinstance(page_tokens, int) and page_tokens >= 1
            and isinstance(n_pages, int) and n_pages >= 1
            and isinstance(tokens, list) and isinstance(metas, list)
            and metas):
        raise HandoffError("header missing page_tokens/n_pages/tokens/"
                           "sections")
    if len(tokens) != n_pages * page_tokens:
        raise HandoffError(f"header token count {len(tokens)} != "
                           f"{n_pages} pages * {page_tokens} tokens")
    if expect_page_tokens is not None and page_tokens != expect_page_tokens:
        raise HandoffError(
            f"page-size mismatch: blob paged at {page_tokens} tokens, "
            f"this arena at {expect_page_tokens}")
    if expect_model is not None \
            and header.get("model", "") != expect_model:
        raise HandoffError(
            f"model mismatch: blob holds KV from "
            f"{header.get('model', '')!r}, this replica serves "
            f"{expect_model!r}")
    if expect_sections is not None:
        got = {m.get("name") for m in metas if isinstance(m, dict)}
        want = set(expect_sections)
        if got != want:
            raise HandoffError(f"section-set mismatch: blob has "
                               f"{sorted(got)}, arena needs {sorted(want)}")
    sections: dict[str, np.ndarray] = {}
    for meta in metas:
        if not isinstance(meta, dict):
            raise HandoffError("malformed section meta")
        name, dname = meta.get("name"), meta.get("dtype")
        shape, nbytes = meta.get("shape"), meta.get("bytes")
        if not (isinstance(name, str) and isinstance(dname, str)
                and isinstance(shape, list) and isinstance(nbytes, int)):
            raise HandoffError(f"malformed section meta: {meta}")
        try:
            dt = _dtype(dname)
            dname = _dtype_name(dname)
        except TypeError as e:
            raise HandoffError(f"section {name!r}: unknown dtype "
                               f"{dname!r}") from e
        shape = tuple(int(s) for s in shape)
        if len(shape) < 3 or shape[1] != n_pages or shape[2] != page_tokens:
            raise HandoffError(f"section {name!r} shape {shape} is not "
                               f"(L, {n_pages}, {page_tokens}, ...)")
        want_bytes = int(np.prod(shape)) * dt.itemsize
        if nbytes != want_bytes:
            raise HandoffError(f"section {name!r}: declared {nbytes} bytes "
                               f"but shape/dtype imply {want_bytes}")
        if len(blob) < off + nbytes:
            raise HandoffError(
                f"truncated stream: section {name!r} needs {nbytes} bytes, "
                f"{len(blob) - off} remain")
        if expect_sections is not None:
            exp_dtype, exp_tail = expect_sections[name]
            if dname != _dtype_name(exp_dtype):
                raise HandoffError(
                    f"dtype mismatch on {name!r}: blob {dname}, "
                    f"arena {_dtype_name(exp_dtype)}")
            if tuple(exp_tail) != shape[3:]:
                raise HandoffError(
                    f"section {name!r} trailing shape {shape[3:]} != "
                    f"arena's {tuple(exp_tail)}")
        sections[name] = np.frombuffer(
            blob, dtype=dt, count=int(np.prod(shape)),
            offset=off).reshape(shape)
        off += nbytes
    if off != len(blob):
        raise HandoffError(f"{len(blob) - off} trailing bytes after the "
                           "declared sections")
    return header, sections


def check_device_sections(tokens: list, sections: dict, *,
                          expect_page_tokens: int,
                          expect_sections: Optional[dict] = None,
                          expect_model: Optional[str] = None,
                          model: str = "",
                          allow_padded: bool = False
                          ) -> tuple[int, dict, int]:
    """The deserialization-side contract (``deserialize_pages``'
    model/section-set/dtype/trailing-shape/page-geometry checks) applied
    directly to LIVE arrays — ONE definition for every device-path door
    (the stream assembler's per-fragment check and the engine's
    monolithic adopt), so the wire and device contracts cannot drift.
    Duck-typed on ``.dtype``/``.shape``/``.nbytes``: torch tensors on the
    card never touch numpy. ``allow_padded`` accepts padded runs and
    returns them trimmed to the true page count (a device-side slice —
    how the padding dies without a host copy); exact-width callers get
    their sections back untouched. Returns (n_pages, sections, nbytes);
    raises HandoffError on any mismatch."""
    t = expect_page_tokens
    if not tokens or len(tokens) % t:
        raise HandoffError(
            f"device run token count {len(tokens)} is not a multiple of "
            f"page_tokens {t}")
    n = len(tokens) // t
    if expect_model is not None and model != expect_model:
        raise HandoffError(
            f"model mismatch: device run holds KV from {model!r}, "
            f"this replica serves {expect_model!r}")
    if expect_sections is not None:
        got, want = set(sections), set(expect_sections)
        if got != want:
            raise HandoffError(
                f"section-set mismatch: device run has {sorted(got)}, "
                f"arena needs {sorted(want)}")
    nbytes = 0
    out = {}
    for name, a in sections.items():
        page_ok = a.shape[1] >= n if allow_padded else a.shape[1] == n
        if a.ndim < 3 or not page_ok or a.shape[2] != t:
            raise HandoffError(
                f"device section {name!r} shape {tuple(a.shape)} is not "
                f"(L, {n}, {t}, ...)")
        if expect_sections is not None:
            exp_dtype, exp_tail = expect_sections[name]
            if dtype_name(a.dtype) != _dtype_name(exp_dtype):
                raise HandoffError(
                    f"dtype mismatch on {name!r}: device run "
                    f"{dtype_name(a.dtype)}, arena {exp_dtype}")
            if tuple(exp_tail) != tuple(a.shape[3:]):
                raise HandoffError(
                    f"device section {name!r} trailing shape "
                    f"{tuple(a.shape[3:])} != arena's {tuple(exp_tail)}")
        out[name] = a[:, :n] if a.shape[1] != n else a
        nbytes += int(out[name].nbytes)
    return n, out, nbytes


# -- streaming chunk frames  ----------------------------------------

def serialize_chunk_frame(stream_id: str, seq: int, payload: bytes, *,
                          final: bool = False,
                          total_tokens: Optional[int] = None) -> bytes:
    """One stream frame: CHUNK_MAGIC | u32 header_len | header JSON |
    payload. ``payload`` is a ``serialize_pages`` blob for this chunk's
    completed pages (empty on a pure close frame). The FINAL frame
    carries ``total_tokens`` — the token count the whole stream claims —
    so a receiver can detect a torn stream even when every individual
    frame parsed (all-or-nothing adoption needs a stream-level length
    check, not just per-frame ones)."""
    if not stream_id:
        raise HandoffError("empty stream id")
    if seq < 0:
        raise HandoffError(f"negative seq {seq}")
    if final and total_tokens is None:
        raise HandoffError("final frame needs total_tokens")
    header = {"version": CHUNK_VERSION, "stream": str(stream_id),
              "seq": int(seq), "final": bool(final),
              "payload_bytes": len(payload)}
    if total_tokens is not None:
        header["total_tokens"] = int(total_tokens)
    raw = json.dumps(header).encode()
    return b"".join([CHUNK_MAGIC, len(raw).to_bytes(4, "big"), raw, payload])


def parse_chunk_frame(blob: bytes) -> tuple[dict, bytes]:
    """(header, payload bytes) of one chunk frame; every malformation —
    truncation, bad magic, foreign version, length drift, trailing
    garbage — raises HandoffError (the assembler then drops the whole
    stream: a stream that ever carried a bad frame must not adopt)."""
    if len(blob) < len(CHUNK_MAGIC) + 4:
        raise HandoffError(f"truncated chunk frame: {len(blob)} bytes")
    if blob[:len(CHUNK_MAGIC)] != CHUNK_MAGIC:
        raise HandoffError("bad magic: not a KV chunk frame")
    hlen = int.from_bytes(blob[len(CHUNK_MAGIC):len(CHUNK_MAGIC) + 4], "big")
    if hlen > _MAX_HEADER_BYTES:
        raise HandoffError(f"chunk header length {hlen} exceeds sanity cap")
    off = len(CHUNK_MAGIC) + 4
    if len(blob) < off + hlen:
        raise HandoffError(f"truncated chunk header: need {hlen} bytes, "
                           f"have {len(blob) - off}")
    try:
        header = json.loads(blob[off:off + hlen])
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise HandoffError(f"unparseable chunk header: {e}") from e
    off += hlen
    if not isinstance(header, dict):
        raise HandoffError("chunk header is not an object")
    if header.get("version") != CHUNK_VERSION:
        raise HandoffError(f"chunk version {header.get('version')!r} not "
                           f"supported (this build speaks {CHUNK_VERSION})")
    stream, seq = header.get("stream"), header.get("seq")
    nbytes = header.get("payload_bytes")
    if not (isinstance(stream, str) and stream and isinstance(seq, int)
            and seq >= 0 and isinstance(nbytes, int) and nbytes >= 0):
        raise HandoffError("chunk header missing stream/seq/payload_bytes")
    if len(blob) - off != nbytes:
        raise HandoffError(
            f"torn chunk frame: payload declares {nbytes} bytes, "
            f"{len(blob) - off} present")
    return header, blob[off:]


def merge_section_frames(done: dict) -> dict[str, np.ndarray]:
    """One {name: (L, n, T, ...)} dict from a closed stream's per-frame
    section dicts (``_close`` hands frames back unmerged so the adoption
    hot path chooses WHERE the concat runs). This is the HOST merge for
    wire-tier consumers; device adopters concatenate device-side instead
    (the serving engine's ``_merged_stream_sections``)."""
    frames = done["section_frames"]
    if len(frames) == 1:
        return dict(frames[0])
    return {name: np.concatenate([f[name] for f in frames], axis=1)
            for name in frames[0]}


class _StreamState:
    __slots__ = ("next_seq", "tokens", "sections", "nbytes", "last_seen")

    def __init__(self, now: float):
        self.next_seq = 0
        self.tokens: list = []
        self.sections: list[dict] = []     # per-frame {name: (L,n,T,...)}
        self.nbytes = 0
        self.last_seen = now


class HandoffStreamAssembler:
    """Strict-order chunk-stream assembly on the decode side: frames are
    buffered HOST-side per stream and the arena is touched only when the
    FINAL frame lands and the whole stream checks out — all-or-nothing
    page accounting by construction (a torn/duplicate/reordered/stale
    stream leaves both arenas exactly as they were).

    Two entry points share ONE seq/TTL state machine: ``feed`` takes wire
    chunk frames (parse + deserialize, the HTTP path), ``feed_fragment``
    takes already-materialized section arrays (the DEVICE transfer path —
    same ordering/TTL/total_tokens discipline, just no
    serialize/deserialize in the middle; fragments buffer as tensors on
    the card and never touch numpy). A stream id is one stream regardless
    of which door its frames came through — a sender that mixed paths
    mid-stream still gets strict-seq treatment.

    Rejection surface (each raises HandoffError and DROPS the stream —
    once a stream carried one bad frame nothing later may resurrect it):
    out-of-order or duplicate ``seq``; a frame for an unknown stream not
    starting at seq 0 (stale sender, or the stream was already dropped);
    per-frame payload validation (deserialize_pages with the adopting
    arena's expectations, or the same geometry checks applied directly to
    device fragments); a final ``total_tokens`` that disagrees with
    what actually arrived; idle streams past ``ttl_s`` (GC'd on every
    feed — an abandoned sender must not pin host memory forever, and a
    final frame arriving AFTER its stream expired is stale, not a
    resurrection).

    Not thread-safe: the engine serializes ``feed``/``feed_fragment``
    under its handoff lock. ``clock`` is injectable (tests drive the TTL
    deterministically)."""

    def __init__(self, *, expect_page_tokens: int,
                 expect_sections: Optional[dict] = None,
                 expect_model: Optional[str] = None,
                 max_streams: int = 8, ttl_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.expect_page_tokens = expect_page_tokens
        self.expect_sections = expect_sections
        self.expect_model = expect_model
        self.max_streams = max_streams
        self.ttl_s = ttl_s
        self.clock = clock
        self._streams: dict[str, _StreamState] = {}

    def __len__(self) -> int:
        return len(self._streams)

    def _gc(self, now: float) -> int:
        dead = [sid for sid, st in self._streams.items()
                if now - st.last_seen > self.ttl_s]
        for sid in dead:
            del self._streams[sid]
        return len(dead)

    def _advance(self, sid: str, seq: int, now: float) -> _StreamState:
        """The shared seq/TTL state machine: open-at-0, strict order,
        bounded stream count. Raises HandoffError (dropping the stream on
        an order violation) — both feed doors go through here."""
        st = self._streams.get(sid)
        if st is None:
            if seq != 0:
                raise HandoffError(
                    f"stale stream {sid!r}: frame seq {seq} for a stream "
                    "this side never opened (expired, dropped, or the "
                    "open frame was lost)")
            if len(self._streams) >= self.max_streams:
                raise HandoffError(
                    f"too many open handoff streams ({self.max_streams})")
            st = self._streams[sid] = _StreamState(now)
        if seq != st.next_seq:
            del self._streams[sid]
            kind = "duplicate" if seq < st.next_seq else "reordered/lost"
            raise HandoffError(
                f"stream {sid!r}: {kind} frame (got seq {seq}, expected "
                f"{st.next_seq}) — stream dropped, nothing adopted")
        st.last_seen = now
        st.next_seq += 1
        return st

    def _close(self, sid: str, st: _StreamState, seq: int,
               total_tokens) -> dict:
        """Final-frame checks + result assembly. The payload comes back
        as ``section_frames`` — the per-frame dicts, NOT concatenated:
        the adopter merges them itself (``merge_section_frames`` below,
        device-side for device fragments), so the close never pays a
        host-side copy of the whole run on the adoption hot path."""
        if total_tokens != len(st.tokens):
            self._streams.pop(sid, None)
            raise HandoffError(
                f"torn stream {sid!r}: final frame claims {total_tokens} "
                f"tokens, {len(st.tokens)} arrived")
        if not st.tokens:
            self._streams.pop(sid, None)
            raise HandoffError(f"stream {sid!r} closed with no pages")
        frames = st.next_seq
        del self._streams[sid]
        return {"final": True, "seq": seq, "tokens": list(st.tokens),
                "bytes": st.nbytes, "frames": frames,
                "section_frames": list(st.sections)}

    def feed(self, blob: bytes) -> dict:
        """One WIRE frame in. Returns {"final": False, "seq"} while the
        stream is still open, or — on a valid final frame — {"final":
        True, "seq", "tokens", "section_frames", "bytes", "frames"}
        ready for arena adoption (merge the frames with
        ``merge_section_frames`` or device-side). Raises HandoffError
        (stream dropped) on any rejection."""
        now = self.clock()
        self._gc(now)
        header, payload = parse_chunk_frame(blob)
        sid, seq = header["stream"], header["seq"]
        st = self._advance(sid, seq, now)
        try:
            if payload:
                hdr, sections = deserialize_pages(
                    payload, expect_page_tokens=self.expect_page_tokens,
                    expect_sections=self.expect_sections,
                    expect_model=self.expect_model)
                st.tokens.extend(hdr["tokens"])
                st.sections.append(sections)
            st.nbytes += len(blob)
        except HandoffError:
            self._streams.pop(sid, None)
            raise
        if not header.get("final"):
            return {"final": False, "seq": seq}
        return self._close(sid, st, seq, header.get("total_tokens"))

    def feed_fragment(self, stream_id: str, seq: int, tokens: list,
                      sections: dict, *, final: bool = False,
                      total_tokens=None, model: str = "") -> dict:
        """One DEVICE fragment in — the zero-serialization door:
        ``sections[name]`` is an (L, n, T, ...) tensor on the card (or a
        host array) for this fragment's pages, already trimmed to its true page
        count. Same state machine, TTL and all-or-nothing close as
        ``feed``; the final result carries ``section_frames`` (per-frame
        dicts, NOT concatenated — the adopter concatenates device-side).
        A pure close fragment passes empty tokens/sections and
        ``final=True`` with ``total_tokens``."""
        if not stream_id:
            raise HandoffError("empty stream id")
        if final and total_tokens is None:
            raise HandoffError("final fragment needs total_tokens")
        now = self.clock()
        self._gc(now)
        st = self._advance(str(stream_id), int(seq), now)
        sid = str(stream_id)
        try:
            if tokens or sections:
                _, checked, nbytes = check_device_sections(
                    list(tokens), sections,
                    expect_page_tokens=self.expect_page_tokens,
                    expect_sections=self.expect_sections,
                    expect_model=self.expect_model, model=model)
                st.nbytes += nbytes
                st.tokens.extend(int(tk) for tk in tokens)
                st.sections.append(checked)
        except HandoffError:
            self._streams.pop(sid, None)
            raise
        if not final:
            return {"final": False, "seq": seq}
        return self._close(sid, st, seq, total_tokens)
