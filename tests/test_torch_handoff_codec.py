"""The port's KV handoff codec (``k8s_runpod_kubelet_tpu_torch/fleet/
handoff.py``) against the JAX package's ``fleet/handoff.py``, both ways:

- for the same sections (f32, bf16, int8 pages with their scales, MLA
  latents, and DeepSeek's dense-prefix ``_pre`` sections beside them) the
  port's blob equals the JAX blob byte for byte, and each package
  deserializes the other's to the same arrays (bf16 in the port as its
  raw 2-byte words, never rounded);
- the port's chunk frames equal the JAX frames;
- every rejection, chunk-frame and stream-assembler case of the JAX
  package's ``tests/test_kv_handoff.py`` holds on the port's codec, the
  device door with torch tensors too.

numpy and torch on the CPU; the JAX side is its numpy codec (``ml_dtypes``
carries its bfloat16).
"""

from __future__ import annotations

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_runpod_kubelet_tpu.fleet import handoff as jh
from k8s_runpod_kubelet_tpu_torch.fleet import handoff as ph
from k8s_runpod_kubelet_tpu_torch.fleet.handoff import (
    CHUNK_MAGIC, CHUNK_VERSION, MAGIC, VERSION, HandoffError,
    HandoffStreamAssembler, check_device_sections, deserialize_pages,
    merge_section_frames, parse_chunk_frame, serialize_chunk_frame,
    serialize_pages)

T = 8   # page_tokens throughout
BF16 = np.dtype(ml_dtypes.bfloat16)


def _tokens(n_pages: int, start_page: int = 0) -> list:
    return [((start_page * T + i) * 7) % 120 + 1 for i in range(n_pages * T)]


def _plain(n_pages: int, dtype=np.float32, seed: int = 0) -> dict:
    rng = np.random.default_rng(1234 + n_pages + seed)
    shape = (2, n_pages, T, 2, 4)
    return {"k": rng.standard_normal(shape).astype(dtype),
            "v": rng.standard_normal(shape).astype(dtype)}


def _int8(n_pages: int) -> dict:
    rng = np.random.default_rng(99)
    q, sc = (2, n_pages, T, 2, 4), (2, n_pages, T, 2)
    return {"k": rng.integers(-128, 128, q).astype(np.int8),
            "v": rng.integers(-128, 128, q).astype(np.int8),
            "k_scale": rng.standard_normal(sc).astype(np.float32),
            "v_scale": rng.standard_normal(sc).astype(np.float32)}


def _mla(n_pages: int) -> dict:
    rng = np.random.default_rng(7)
    return {"c": rng.standard_normal((2, n_pages, T, 16)).astype(np.float32),
            "kr": rng.standard_normal((2, n_pages, T, 8)).astype(np.float32)}


def _dense_prefix(n_pages: int) -> dict:
    """DeepSeek's arena: the routed layers' int8 latents and their
    per-position scales, and the dense prefix layer's own ``_pre``
    sections, of another layer count."""
    rng = np.random.default_rng(11)
    out = {}
    for sfx, layers in (("", 3), ("_pre", 1)):
        for name, width in (("c", 16), ("kr", 8)):
            out[name + sfx] = rng.integers(
                -128, 128, (layers, n_pages, T, width)).astype(np.int8)
            out[name + sfx + "_scale"] = rng.standard_normal(
                (layers, n_pages, T)).astype(np.float32)
    return out


LAYOUTS = {
    "f32": _plain,
    "bf16": lambda n: _plain(n, BF16),
    "int8_scales": _int8,
    "mla": _mla,
    "dense_prefix": _dense_prefix,
}


def _words(a: np.ndarray) -> np.ndarray:
    """A JAX-side array as the port holds it: bf16 as uint16 words."""
    return a.view(np.uint16) if a.dtype == BF16 else a


def _port_args(sections: dict) -> tuple[dict, dict]:
    """The port's serialize input: bf16 sections as raw words plus their
    dtype names."""
    return ({n: _words(a) for n, a in sections.items()},
            {n: "bfloat16" for n, a in sections.items() if a.dtype == BF16})


def _spec(sections: dict) -> dict:
    return {n: (a.dtype.name, a.shape[3:]) for n, a in sections.items()}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_port_blob_equals_the_jax_blob_and_each_reads_the_other(layout):
    sections = LAYOUTS[layout](3)
    tokens = _tokens(3)
    jblob = jh.serialize_pages(tokens, T, sections, model="m")
    words, dtypes = _port_args(sections)
    pblob = serialize_pages(tokens, T, words, model="m", dtypes=dtypes)
    assert pblob == jblob
    # the JAX package reads the port's blob
    header, out = jh.deserialize_pages(pblob, expect_page_tokens=T,
                                       expect_sections=_spec(sections),
                                       expect_model="m")
    assert header["tokens"] == tokens and header["n_pages"] == 3
    for name, a in sections.items():
        assert out[name].dtype == a.dtype
        np.testing.assert_array_equal(out[name], a)
    # and the port reads the JAX blob, bf16 as its words
    header, out = deserialize_pages(jblob, expect_page_tokens=T,
                                    expect_sections=_spec(sections),
                                    expect_model="m")
    assert header["tokens"] == tokens
    assert [m["dtype"] for m in header["sections"]] == \
        [a.dtype.name for a in sections.values()]
    for name, a in sections.items():
        np.testing.assert_array_equal(out[name], _words(a))
        assert out[name].tobytes() == a.tobytes()


def test_bf16_words_become_torch_bfloat16_bit_for_bit():
    x = torch.randn(2, 2, T, 4).to(torch.bfloat16)
    words = x.view(torch.int16).numpy().view(np.uint16)
    blob = serialize_pages(_tokens(2), T, {"k": words},
                           dtypes={"k": "bfloat16"})
    _, out = deserialize_pages(blob, expect_sections={"k": ("bfloat16",
                                                           (4,))})
    back = torch.from_numpy(out["k"].view(np.int16).copy()).view(
        torch.bfloat16)
    assert torch.equal(back, x)
    # the JAX side reads the same values
    _, jout = jh.deserialize_pages(blob)
    np.testing.assert_array_equal(jout["k"].astype(np.float32),
                                  x.float().numpy())


def _doctor(blob: bytes, magic: bytes, edit) -> bytes:
    hlen = int.from_bytes(blob[len(magic):len(magic) + 4], "big")
    header = json.loads(blob[len(magic) + 4:len(magic) + 4 + hlen])
    edit(header)
    raw = json.dumps(header).encode()
    return magic + len(raw).to_bytes(4, "big") + raw \
        + blob[len(magic) + 4 + hlen:]


def _blob(n_pages=2, sections=None, model=""):
    sections = sections if sections is not None else _plain(n_pages)
    return serialize_pages(_tokens(n_pages), T, sections, model=model)


def _future(h):
    h["version"] = VERSION + 1


def _bytes_off(h):
    h["sections"][0]["bytes"] += 4


REJECTIONS = {
    # name: (makes the blob, deserialize kwargs, message pattern)
    **{f"truncated_{cut}": (lambda cut=cut: _blob()[:cut] if cut >= 0
                            else _blob()[:len(_blob()) + cut], {}, None)
       for cut in (0, 3, len(MAGIC) + 2, len(MAGIC) + 8, 300, -1)},
    "truncated_half": (lambda: _blob()[:len(_blob()) // 2], {}, None),
    "trailing_garbage": (lambda: _blob() + b"\x00", {}, "trailing"),
    "bad_magic": (lambda: b"NOTKV\x01" + _blob()[len(MAGIC):], {}, "magic"),
    "future_version": (lambda: _doctor(_blob(), MAGIC, _future), {},
                       "version"),
    "unparseable_header": (lambda: MAGIC + (9).to_bytes(4, "big")
                           + b"{not json", {}, "header"),
    "absurd_header_length": (lambda: MAGIC + (1 << 31).to_bytes(4, "big")
                             + b"x", {}, "sanity cap"),
    "page_size": (_blob, {"expect_page_tokens": T * 2}, "page-size"),
    "model": (lambda: _blob(model="llama3-8b"),
              {"expect_model": "llama3.1-8b"}, "model mismatch"),
    "unstamped_model": (_blob, {"expect_model": "llama3-8b"},
                        "model mismatch"),
    "dtype": (_blob, {"expect_sections": {"k": ("float16", (2, 4)),
                                          "v": ("float32", (2, 4))}},
              "dtype mismatch"),
    "bf16_vs_its_words": (
        lambda: _blob(sections={k: _words(v) for k, v in
                                _plain(2, BF16).items()}),
        {"expect_sections": {"k": ("bfloat16", (2, 4)),
                             "v": ("bfloat16", (2, 4))}},
        "dtype mismatch"),
    "section_set": (lambda: _blob(sections=_int8(2)),
                    {"expect_sections": _spec(_plain(2))}, "section-set"),
    "trailing_shape": (_blob, {"expect_sections": {"k": ("float32", (4, 2)),
                                                   "v": ("float32",
                                                         (2, 4))}},
                       "trailing shape"),
    "declared_bytes": (lambda: _doctor(_blob(), MAGIC, _bytes_off), {},
                       "declared"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_deserialize_rejections(case):
    make, kw, pattern = REJECTIONS[case]
    blob = make()
    with pytest.raises(HandoffError, match=pattern):
        deserialize_pages(blob, **kw)
    with pytest.raises(jh.HandoffError, match=pattern):
        jh.deserialize_pages(blob, **kw)


SERIALIZE_REJECTIONS = {
    "token_count": (lambda: (_tokens(2)[:-1], _plain(2), None),
                    "token count"),
    "no_sections": (lambda: (_tokens(1), {}, None), "no sections"),
    "misshapen": (lambda: (_tokens(3), {"k": np.zeros((2, 3, T + 1, 4),
                                                      np.float32)}, None),
                  "shape"),
    "words_too_narrow": (lambda: (_tokens(1), _plain(1),
                                  {"k": "bfloat16"}), "cannot carry"),
}


@pytest.mark.parametrize("case", sorted(SERIALIZE_REJECTIONS))
def test_serialize_rejections(case):
    make, pattern = SERIALIZE_REJECTIONS[case]
    tokens, sections, dtypes = make()
    with pytest.raises(HandoffError, match=pattern):
        serialize_pages(tokens, T, sections, dtypes=dtypes)


# -- chunk frames --------------------------------------------------------------

def _frame(stream: str, seq: int, n_pages: int, *, final=False, total=None,
           start_page: int = 0, model: str = "", codec=ph) -> bytes:
    payload = b""
    if n_pages:
        payload = codec.serialize_pages(
            _tokens(n_pages, start_page), T,
            _plain(n_pages, seed=hash((stream, start_page)) % 1000),
            model=model)
    return codec.serialize_chunk_frame(stream, seq, payload, final=final,
                                       total_tokens=total)


def test_chunk_frames_equal_the_jax_frames():
    for args, kw in ((("s1", 0, 2), {}), (("s1", 3, 1), {"start_page": 2}),
                     (("s1", 4, 0), {"final": True, "total": 5 * T})):
        assert _frame(*args, **kw) == _frame(*args, **kw, codec=jh)
    header, payload = parse_chunk_frame(_frame("s1", 3, 2))
    assert (header["stream"], header["seq"], header["final"]) == \
        ("s1", 3, False)
    assert deserialize_pages(payload)[0]["n_pages"] == 2
    assert jh.parse_chunk_frame(_frame("s1", 3, 2)) == (header, payload)


def _foreign(h):
    h["version"] = CHUNK_VERSION + 1


FRAME_REJECTIONS = {
    **{f"torn_{cut}": (lambda cut=cut: _frame("s1", 0, 2)[:cut], None)
       for cut in (0, 3, len(CHUNK_MAGIC) + 2, len(CHUNK_MAGIC) + 8, 200)},
    "torn_half": (lambda: _frame("s1", 0, 2)[:len(_frame("s1", 0, 2)) // 2],
                  None),
    "one_byte_short": (lambda: _frame("s1", 0, 2)[:-1], "torn"),
    "whole_run_blob": (lambda: _blob(1), "magic"),
    "foreign_version": (lambda: _doctor(_frame("s1", 0, 1), CHUNK_MAGIC,
                                        _foreign), "version"),
    "payload_drift": (lambda: _frame("s1", 0, 1) + b"\x00", "torn"),
}


@pytest.mark.parametrize("case", sorted(FRAME_REJECTIONS))
def test_chunk_frame_rejections(case):
    make, pattern = FRAME_REJECTIONS[case]
    with pytest.raises(HandoffError, match=pattern):
        parse_chunk_frame(make())


def test_final_frame_needs_total_tokens():
    with pytest.raises(HandoffError, match="total_tokens"):
        serialize_chunk_frame("s", 1, b"", final=True)
    assert _blob(1)[:len(MAGIC)] != CHUNK_MAGIC


# -- the stream assembler ------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _asm(clock=None, **kw) -> HandoffStreamAssembler:
    kw.setdefault("expect_page_tokens", T)
    kw.setdefault("expect_sections", _spec(_plain(1)))
    if clock is not None:
        kw["clock"] = clock
    return HandoffStreamAssembler(**kw)


def _close(sid, seq, total):
    return serialize_chunk_frame(sid, seq, b"", final=True,
                                 total_tokens=total)


def _in_order():
    asm = _asm()
    assert asm.feed(_frame("s1", 0, 2)) == {"final": False, "seq": 0}
    assert asm.feed(_frame("s1", 1, 3, start_page=2)) == \
        {"final": False, "seq": 1}
    out = asm.feed(_close("s1", 2, 5 * T))
    assert out["final"] and len(out["tokens"]) == 5 * T
    assert out["frames"] == 3 and len(asm) == 0
    merged = merge_section_frames(out)
    assert merged["k"].shape == (2, 5, T, 2, 4)
    np.testing.assert_array_equal(
        merged["k"][:, :2], _plain(2, seed=hash(("s1", 0)) % 1000)["k"])


def _interleaved():
    asm = _asm()
    asm.feed(_frame("a", 0, 1))
    asm.feed(_frame("b", 0, 2))
    asm.feed(_frame("a", 1, 1, start_page=1))
    out_b = asm.feed(_close("b", 1, 2 * T))
    out_a = asm.feed(_close("a", 2, 2 * T))
    assert merge_section_frames(out_a)["k"].shape[1] == 2
    assert merge_section_frames(out_b)["k"].shape[1] == 2


def _duplicate():
    asm = _asm()
    asm.feed(_frame("s1", 0, 1))
    asm.feed(_frame("s1", 1, 1, start_page=1))
    with pytest.raises(HandoffError, match="duplicate"):
        asm.feed(_frame("s1", 1, 1, start_page=1))
    assert len(asm) == 0
    with pytest.raises(HandoffError, match="stale"):
        asm.feed(_frame("s1", 2, 1, start_page=2))


def _reordered():
    asm = _asm()
    asm.feed(_frame("s1", 0, 1))
    with pytest.raises(HandoffError, match="reordered|lost"):
        asm.feed(_frame("s1", 2, 1, start_page=2))
    assert len(asm) == 0


def _stale():
    asm = _asm()
    with pytest.raises(HandoffError, match="stale"):
        asm.feed(_frame("ghost", 3, 1))
    assert len(asm) == 0


def _torn_total():
    asm = _asm()
    asm.feed(_frame("s1", 0, 1))
    with pytest.raises(HandoffError, match="torn"):
        asm.feed(_close("s1", 1, 5 * T))
    assert len(asm) == 0


def _bad_payload():
    asm = _asm()
    asm.feed(_frame("s1", 0, 1))
    good = _frame("s1", 1, 1, start_page=1)
    hlen = int.from_bytes(good[len(CHUNK_MAGIC):len(CHUNK_MAGIC) + 4], "big")
    header = json.loads(good[len(CHUNK_MAGIC) + 4:len(CHUNK_MAGIC) + 4
                             + hlen])
    torn = good[len(CHUNK_MAGIC) + 4 + hlen:][:-3]
    header["payload_bytes"] = len(torn)
    raw = json.dumps(header).encode()
    with pytest.raises(HandoffError):
        asm.feed(CHUNK_MAGIC + len(raw).to_bytes(4, "big") + raw + torn)
    assert len(asm) == 0


def _empty():
    with pytest.raises(HandoffError, match="no pages"):
        _asm().feed(_close("s1", 0, 0))


def _model_per_frame():
    with pytest.raises(HandoffError, match="model mismatch"):
        _asm(expect_model="llama3-8b").feed(
            _frame("s1", 0, 1, model="llama3.1-8b"))


def _idle_expiry():
    clock = _Clock()
    asm = _asm(clock=clock, ttl_s=10.0)
    asm.feed(_frame("s1", 0, 1))
    clock.t = 11.0
    asm.feed(_frame("s2", 0, 1))
    assert len(asm) == 1
    with pytest.raises(HandoffError, match="stale"):
        asm.feed(_frame("s1", 1, 1, start_page=1))


def _max_streams():
    asm = _asm(max_streams=2)
    asm.feed(_frame("a", 0, 1))
    asm.feed(_frame("b", 0, 1))
    with pytest.raises(HandoffError, match="too many"):
        asm.feed(_frame("c", 0, 1))


def _late_final_after_expiry():
    clock = _Clock()
    asm = _asm(clock=clock, ttl_s=10.0)
    asm.feed(_frame("s1", 0, 2))
    asm.feed(_frame("s1", 1, 1, start_page=2))
    clock.t = 10.1
    with pytest.raises(HandoffError, match="stale"):
        asm.feed(_close("s1", 2, 3 * T))
    assert len(asm) == 0
    assert asm.feed(_frame("s1", 0, 1)) == {"final": False, "seq": 0}
    clock.t = 20.0
    asm2 = _asm(clock=clock, ttl_s=10.0)
    asm2.feed_fragment("d1", 0, _tokens(1), _torch(_plain(1)))
    clock.t = 30.5
    with pytest.raises(HandoffError, match="stale"):
        asm2.feed_fragment("d1", 1, [], {}, final=True, total_tokens=T)
    assert len(asm2) == 0


def _torch(sections: dict) -> dict:
    return {n: torch.from_numpy(a.copy()) for n, a in sections.items()}


def _fragments_assemble():
    asm = _asm()
    s0, s1 = _torch(_plain(2)), _torch(_plain(1))
    assert asm.feed_fragment("d", 0, _tokens(2), s0) == \
        {"final": False, "seq": 0}
    asm.feed_fragment("d", 1, _tokens(1, 2), s1)
    out = asm.feed_fragment("d", 2, [], {}, final=True, total_tokens=3 * T)
    assert out["final"] and len(out["tokens"]) == 3 * T
    assert out["bytes"] == sum(int(a.nbytes) for s in (s0, s1)
                               for a in s.values())
    assert len(out["section_frames"]) == 2
    assert out["section_frames"][0]["k"] is s0["k"] and len(asm) == 0


def _one_lane_across_doors():
    asm = _asm()
    asm.feed(_frame("x", 0, 1))
    asm.feed_fragment("x", 1, _tokens(1, 1), _torch(_plain(1)))
    with pytest.raises(HandoffError, match="duplicate"):
        asm.feed_fragment("x", 1, _tokens(1, 1), _torch(_plain(1)))
    assert len(asm) == 0


def _fragment_model():
    with pytest.raises(HandoffError, match="model mismatch"):
        _asm(expect_model="llama3-8b").feed_fragment(
            "m", 0, _tokens(1), _torch(_plain(1)), model="llama3.1-8b")


def _fragment_partial_page():
    with pytest.raises(HandoffError, match="not a multiple"):
        _asm().feed_fragment("p", 0, _tokens(1)[:-1], _torch(_plain(1)))


def _fragment_final_needs_total():
    asm = _asm()
    asm.feed_fragment("f", 0, _tokens(1), _torch(_plain(1)))
    with pytest.raises(HandoffError, match="total_tokens"):
        asm.feed_fragment("f", 1, [], {}, final=True)


ASSEMBLER = {f.__name__.lstrip("_"): f for f in (
    _in_order, _interleaved, _duplicate, _reordered, _stale, _torn_total,
    _bad_payload, _empty, _model_per_frame, _idle_expiry, _max_streams,
    _late_final_after_expiry, _fragments_assemble, _one_lane_across_doors,
    _fragment_model, _fragment_partial_page, _fragment_final_needs_total)}


@pytest.mark.parametrize("case", sorted(ASSEMBLER))
def test_stream_assembler(case):
    ASSEMBLER[case]()


GEOMETRY = {
    "section_set": (lambda s: {k: v for k, v in s.items() if k != "v"},
                    "section-set"),
    "dtype": (lambda s: {**s, "v": s["v"].half()}, "dtype mismatch"),
    "trailing_shape": (lambda s: {**s, "v": s["v"][:, :, :, :, :2]},
                       "trailing shape"),
    "page_tokens": (lambda s: {**s, "v": s["v"][:, :, :4]}, r"not \(L, 1"),
}


@pytest.mark.parametrize("case", sorted(GEOMETRY))
def test_device_fragment_geometry_rejections(case):
    mutate, pattern = GEOMETRY[case]
    asm = _asm()
    with pytest.raises(HandoffError, match=pattern):
        asm.feed_fragment("g", 0, _tokens(1), mutate(_torch(_plain(1))))
    assert len(asm) == 0


def test_check_device_sections_reads_torch_dtypes_and_trims_padding():
    spec = {"k": ("bfloat16", (2, 4)), "k_scale": ("float32", (2,))}
    padded = {"k": torch.zeros(2, 4, T, 2, 4, dtype=torch.bfloat16),
              "k_scale": torch.zeros(2, 4, T, 2)}
    n, out, nbytes = check_device_sections(
        _tokens(3), padded, expect_page_tokens=T, expect_sections=spec,
        allow_padded=True)
    assert n == 3 and out["k"].shape == (2, 3, T, 2, 4)
    assert nbytes == 2 * 3 * T * (2 * 4 * 2 + 2 * 4)
    with pytest.raises(HandoffError, match="is not"):
        check_device_sections(_tokens(3), padded, expect_page_tokens=T,
                              expect_sections=spec)
    assert ph.dtype_name(torch.bfloat16) == "bfloat16"
    assert ph.dtype_name(np.dtype(np.int8)) == "int8"
