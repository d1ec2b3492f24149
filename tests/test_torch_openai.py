"""The port's OpenAI front against the JAX package's server, on the CPU.

Both servers run an engine over the same f32 tiny weights (vocab 260, so
the byte tokenizer's ids fit) with ``ByteTokenizer`` and EOS 256, and get
the same requests in the same order; ``logit_bias`` on a few byte ids
makes the random model write text. Held:

- /v1/completions (string and token prompts), /v1/chat/completions and
  n = 2: the same choices, finish reasons and usage (ids and timestamps
  aside);
- stop token lists and stop strings cut the text the same way;
- logprobs within 1e-5;
- SSE: the same chunk sequence, concatenating to the non-streamed text and
  ending in ``data: [DONE]``; streamed /generate NDJSON lines equal;
- /v1/embeddings within 1e-5 relative (float and base64), and the error
  codes of a bad model, encoding, input and an over-long input;
- /v1/models and /debug/steps;
- 429 at ``max_queue_depth``, in the OpenAI error shape on /v1/*;
- a raising ``on_token`` cancels its request at once.
"""

import base64
import json
import struct
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.workloads import serve_main as jserve
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu.workloads.tokenizer import \
    ByteTokenizer as JaxByteTokenizer
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.tokenizer import ByteTokenizer

TIMEOUT = 120
JCFG = jllama.tiny_llama(vocab_size=260, embed_dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                         dtype=jnp.float32, param_dtype=jnp.float32)
BIAS = {str(b): 40 for b in b"abcde \n"}
MAX_PREFILL = 32


def _sc(cls, **kw):
    base = dict(slots=4, max_prefill_len=MAX_PREFILL, cache_len=96,
                max_new_tokens=12, kv_page_tokens=8, eos_token=256)
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def servers():
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(JCFG, jax.random.PRNGKey(7)))
    jeng = JaxServingEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, tree),
                            _sc(JaxServingConfig),
                            decode_fn=JaxByteTokenizer().decode).start()
    cfg = config_from_jax(JCFG, torch.float32)
    tok = ByteTokenizer()
    eng = ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                        _sc(ServingConfig), device="cpu",
                        decode_fn=tok.decode).start()
    jhttpd = jserve.serve(jeng, 0, tokenizer=JaxByteTokenizer())
    httpd = serve_main.serve(eng, 0, tokenizer=tok, host="127.0.0.1")
    yield {"port": httpd.server_address[1],
           "jax": jhttpd.server_address[1], "engine": eng, "jengine": jeng,
           "tree": tree}
    for h in (httpd, jhttpd):
        h.shutdown()
        h.server_close()
    eng.stop()
    jeng.stop()


def _http(port: int, path: str, body=None, method: str = "POST"):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _both(servers, path, body=None, method="POST"):
    """(port's, JAX server's) (status, headers, body), one request each."""
    return (_http(servers["port"], path, body, method),
            _http(servers["jax"], path, body, method))


def _strip(obj: dict) -> dict:
    return {k: v for k, v in obj.items() if k not in ("id", "created")}


def _same_json(servers, path, body):
    (s1, _, b1), (s2, _, b2) = _both(servers, path, body)
    assert s1 == s2 == 200, (b1, b2)
    got, want = json.loads(b1), json.loads(b2)
    assert _strip(got) == _strip(want)
    return got


@pytest.mark.parametrize("prompt", ["hello there", [104, 105, 33, 10]],
                         ids=["text", "tokens"])
def test_completions_match_the_jax_server(servers, prompt):
    out = _same_json(servers, "/v1/completions",
                     {"prompt": prompt, "max_tokens": 10, "temperature": 0,
                      "logit_bias": BIAS})
    choice = out["choices"][0]
    assert out["object"] == "text_completion" and choice["text"]
    assert out["usage"]["prompt_tokens"] == (
        len(prompt) if isinstance(prompt, list) else len(prompt.encode()))
    assert out["usage"]["total_tokens"] == (out["usage"]["prompt_tokens"]
                                            + out["usage"]["completion_tokens"])


def test_chat_with_n_2_matches_the_jax_server(servers):
    body = {"messages": [{"role": "system", "content": "be brief"},
                         {"role": "user", "content": "hi"}],
            "n": 2, "max_tokens": 8, "temperature": 0, "logit_bias": BIAS}
    dense0 = servers["engine"].counters["dense_prefills"]
    out = _same_json(servers, "/v1/chat/completions", body)
    assert servers["engine"].counters["dense_prefills"] == dense0 + 1
    assert [c["index"] for c in out["choices"]] == [0, 1]
    # greedy: both members decode the same tokens from one prefill
    assert out["choices"][0]["message"] == out["choices"][1]["message"]
    assert out["choices"][0]["message"]["role"] == "assistant"
    # sampled: the port draws from its own seeded streams, not
    # jax.random's, so only the shape is the reference's; member i draws
    # with seed + i, and the same seed repeats
    body = dict(body, temperature=0.9, seed=5, max_tokens=4)
    (s1, _, b1), (s2, _, b2) = _both(servers, "/v1/chat/completions", body)
    assert s1 == s2 == 200
    got, want = json.loads(b1), json.loads(b2)
    assert got["usage"] == want["usage"]
    assert [c["index"] for c in got["choices"]] == [0, 1]
    again = json.loads(_http(servers["port"], "/v1/chat/completions",
                             body)[2])
    assert again["choices"] == got["choices"]


def test_stops_cut_the_text_as_the_jax_server(servers):
    base = {"prompt": "stop here", "max_tokens": 12, "temperature": 0,
            "logit_bias": BIAS}
    full = _same_json(servers, "/v1/completions", base)
    text = full["choices"][0]["text"]
    stop = text[len(text) // 2]
    cut = _same_json(servers, "/v1/completions", dict(base, stop=stop))
    assert cut["choices"][0]["text"] == text[:text.index(stop)]
    assert cut["choices"][0]["finish_reason"] == "stop"
    (s1, _, b1), (s2, _, b2) = _both(
        servers, "/generate", {"text": "stop here", "max_new_tokens": 12,
                               "temperature": 0, "logit_bias": BIAS,
                               "stop": [[ord(stop)]]})
    assert s1 == s2 == 200
    toks, want = json.loads(b1), json.loads(b2)
    assert set(toks) == set(want) == {"rid", "tokens", "latency_s", "text"}
    assert (toks["tokens"], toks["text"]) == (want["tokens"], want["text"])
    assert toks["tokens"][-1] == ord(stop)
    assert toks["text"] == text[:text.index(stop) + 1]


def test_logprobs_match_within_1e_5(servers):
    body = {"prompt": "log", "max_tokens": 6, "temperature": 0,
            "logit_bias": BIAS, "logprobs": 1}
    (s1, _, b1), (s2, _, b2) = _both(servers, "/v1/completions", body)
    assert s1 == s2 == 200
    got = json.loads(b1)["choices"][0]["logprobs"]
    want = json.loads(b2)["choices"][0]["logprobs"]
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"],
                               atol=1e-5, rtol=0)
    assert all(lp <= 0 for lp in got["token_logprobs"])
    # the engine's own result, from a sampled request: one per token
    out = servers["engine"].submit([5, 6, 7], max_new_tokens=5,
                                   temperature=0.7, seed=3,
                                   logprobs=True).result(timeout=TIMEOUT)
    assert len(out["logprobs"]) == 5 and max(out["logprobs"]) <= 0


def _sse(body: bytes) -> list:
    frames = body.decode().split("\n\n")
    assert frames[-1] == "" and all(f.startswith("data: ")
                                    for f in frames[:-1])
    return [f[len("data: "):] for f in frames[:-1]]


@pytest.mark.parametrize("chat", [False, True], ids=["completions", "chat"])
def test_sse_framing_matches_the_jax_server(servers, chat):
    path = "/v1/chat/completions" if chat else "/v1/completions"
    body = ({"messages": [{"role": "user", "content": "stream"}]} if chat
            else {"prompt": "stream me"})
    body.update(max_tokens=9, temperature=0, logit_bias=BIAS)
    flat = _same_json(servers, path, body)
    (s1, h1, b1), (s2, _, b2) = _both(servers, path, dict(body, stream=True))
    assert s1 == s2 == 200 and h1["Content-Type"] == "text/event-stream"
    got, want = _sse(b1), _sse(b2)
    assert got[-1] == want[-1] == "[DONE]"
    chunks = [json.loads(x) for x in got[:-1]]
    assert [_strip(c) for c in chunks] == [_strip(json.loads(x))
                                           for x in want[:-1]]
    if chat:
        text = "".join(c["choices"][0]["delta"].get("content", "")
                       for c in chunks)
        assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
        assert text == flat["choices"][0]["message"]["content"]
    else:
        text = "".join(c["choices"][0]["text"] for c in chunks)
        assert text == flat["choices"][0]["text"]
    assert chunks[-1]["choices"][0]["finish_reason"] == \
        flat["choices"][0]["finish_reason"]


def test_streamed_generate_matches_the_jax_server(servers):
    body = {"tokens": [9, 8, 7, 6], "max_new_tokens": 5, "stream": True,
            "logit_bias": BIAS}
    (s1, h1, b1), (s2, _, b2) = _both(servers, "/generate", body)
    assert s1 == s2 == 200 and h1["Content-Type"] == "application/x-ndjson"
    got = [json.loads(x) for x in b1.decode().splitlines()]
    want = [json.loads(x) for x in b2.decode().splitlines()]
    assert got[:-1] == want[:-1] and len(got) == 6
    keep = ("tokens", "text")
    assert {k: got[-1][k] for k in keep} == {k: want[-1][k] for k in keep}


def test_embeddings_match_the_jax_server(servers):
    inputs = ["an embedding", [3, 1, 4, 1, 5, 9, 2, 6] * 4]
    (s1, _, b1), (s2, _, b2) = _both(servers, "/v1/embeddings",
                                     {"input": inputs})
    assert s1 == s2 == 200
    got, want = json.loads(b1), json.loads(b2)
    assert got["usage"] == want["usage"] == {"prompt_tokens": 12 + 32,
                                             "total_tokens": 12 + 32}
    for a, b in zip(got["data"], want["data"]):
        va, vb = np.array(a["embedding"]), np.array(b["embedding"])
        assert va.shape == (64,)
        assert np.linalg.norm(va - vb) <= 1e-5 * np.linalg.norm(vb)
    (s1, _, b1) = _http(servers["port"], "/v1/embeddings",
                        {"input": inputs[0], "encoding_format": "base64"})
    raw = base64.b64decode(json.loads(b1)["data"][0]["embedding"])
    assert list(struct.unpack("<64f", raw)) == pytest.approx(
        got["data"][0]["embedding"], rel=1e-6)
    before = servers["engine"].counters["embeds"]
    for bad, code in (({"input": [1] * (MAX_PREFILL + 1)}, 400),
                      ({"input": "x", "model": "other"}, 404),
                      ({"input": "x", "encoding_format": "int8"}, 400),
                      ({"input": "x", "dimensions": 3}, 400),
                      ({}, 400), ({"input": [[]]}, 400)):
        (s1, _, b1), (s2, _, b2) = _both(servers, "/v1/embeddings", bad)
        assert s1 == s2 == code, bad
        assert json.loads(b1)["error"]["type"] == \
            json.loads(b2)["error"]["type"]
    assert servers["engine"].counters["embeds"] == before


def test_models_and_debug_steps(servers):
    (s1, _, b1), (s2, _, b2) = _both(servers, "/v1/models", method="GET")
    assert s1 == s2 == 200
    assert [m["id"] for m in json.loads(b1)["data"]] == \
        [m["id"] for m in json.loads(b2)["data"]] == ["tiny"]
    (s1, _, b1), (s2, _, b2) = _both(servers, "/debug/steps?n=4",
                                     method="GET")
    assert s1 == s2 == 200
    got, want = json.loads(b1), json.loads(b2)
    assert set(got) == set(want) and got["enabled"] is True
    assert set(got["rollup"]) == set(want["rollup"])
    assert 0 < len(got["steps"]) <= 4
    assert set(got["steps"][-1]["phases"]) == set(
        want["steps"][-1]["phases"])
    assert _both(servers, "/debug/steps?n=x", method="GET")[0][0] == 400


def test_429_at_max_queue_depth(servers):
    """Engines not started: the first submit stays queued, the next one
    finds the queue at its bound."""
    cfg = config_from_jax(JCFG, torch.float32)
    eng = ServingEngine(cfg, params_from_jax(servers["tree"], cfg,
                                             device="cpu"),
                        _sc(ServingConfig, max_queue_depth=1), device="cpu")
    jeng = JaxServingEngine(JCFG, jax.tree_util.tree_map(jnp.asarray,
                                                         servers["tree"]),
                            _sc(JaxServingConfig, max_queue_depth=1))
    httpd = serve_main.serve(eng, 0, tokenizer=ByteTokenizer(),
                             host="127.0.0.1")
    jhttpd = jserve.serve(jeng, 0, tokenizer=JaxByteTokenizer())
    pair = {"port": httpd.server_address[1],
            "jax": jhttpd.server_address[1]}
    try:
        queued = eng.submit([1, 2, 3])
        jeng.submit([1, 2, 3])
        assert eng.queue_depth == 1
        for path, body in (("/v1/completions", {"prompt": "x"}),
                           ("/v1/chat/completions", {"messages": [
                               {"role": "user", "content": "x"}]}),
                           ("/generate", {"tokens": [4]}),
                           ("/v1/completions", {"prompt": "x",
                                                "stream": True})):
            (s1, h1, b1), (s2, _, b2) = _both(pair, path, body)
            assert s1 == s2 == 429, (path, b1)
            assert h1["Retry-After"] == "1"
            assert json.loads(b1).keys() == json.loads(b2).keys()
            if path.startswith("/v1/"):
                assert json.loads(b1)["error"]["type"] == "overloaded_error"
        # a group counts all its members against the bound
        fs = eng.submit_group([1, 2], 2)
        assert len(fs) == 2 and all(
            isinstance(f.exception(), type(fs[0].exception())) for f in fs)
        assert not queued.done()
    finally:
        for h in (httpd, jhttpd):
            h.shutdown()
            h.server_close()


def test_raising_on_token_cancels_the_request(servers):
    def gone(_tok):
        raise ConnectionError("client went away")

    outs = []
    for eng in (servers["engine"], servers["jengine"]):
        outs.append(eng.submit([7, 7, 7, 7], max_new_tokens=10,
                               on_token=gone).result(timeout=TIMEOUT))
    assert len(outs[0]["tokens"]) == len(outs[1]["tokens"]) == 1
    assert outs[0]["tokens"] == outs[1]["tokens"]
    assert servers["engine"].counters["stream_cancelled"] >= 1
    # the engine serves on
    deadline = time.monotonic() + TIMEOUT
    while servers["engine"].active_slots:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert len(servers["engine"].submit([1, 2], max_new_tokens=3).result(
        timeout=TIMEOUT)["tokens"]) == 3
