"""The port's tokenizers against the JAX package's, on the CPU.

``HfTokenizer`` over a GPT-2-style BPE directory this test builds itself
(no tokenizer file is fetched), with and without a chat template, equals
the JAX ``HfTokenizer`` in ``encode``, ``encode_plain``, ``decode``,
``apply_chat`` and ``eos_id``; ``ByteTokenizer`` equals the JAX one too;
``get_tokenizer`` maps its spec the same way.
"""

import json

import pytest

from k8s_runpod_kubelet_tpu.workloads import tokenizer as jtok
from k8s_runpod_kubelet_tpu_torch.workloads import tokenizer as ttok

TEXTS = ["abacus", "a b c", "zzz yak", "ab ba ca", "", "héllo ✓ wörld"]
CHATS = [[{"role": "user", "content": "abc"}],
         [{"role": "system", "content": "be brief"},
          {"role": "user", "content": "hi ab"},
          {"role": "assistant", "content": "ok"},
          {"role": "user", "content": "more"}]]
TEMPLATE = ("{% for m in messages %}<|endoftext|>{{ m['role'] }} "
            "{{ m['content'] }}{% endfor %}{% if add_generation_prompt %}"
            "<|endoftext|>assistant {% endif %}")


def _build_bpe_dir(path, chat_template=None):
    """A GPT-2-style vocab of a-z singles and two-letter merges (merges
    only for a-initial pairs), as tests/test_bpe_stops.py builds."""
    singles = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    pairs = [a + b for a in singles[:17] for b in singles[:17]]
    vocab = {t: i for i, t in enumerate(singles + pairs)}
    vocab["Ġ"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n" + "".join(
        f"{p[0]} {p[1]}\n" for p in pairs if p[0] == "a"))
    config = {"tokenizer_class": "GPT2Tokenizer", "model_max_length": 1024,
              "unk_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
              "bos_token": "<|endoftext|>"}
    if chat_template:
        config["chat_template"] = chat_template
    (path / "tokenizer_config.json").write_text(json.dumps(config))
    return str(path)


@pytest.fixture(scope="module", params=[None, TEMPLATE],
                ids=["fallback_chat", "chat_template"])
def pair(request, tmp_path_factory):
    pytest.importorskip("transformers")
    path = _build_bpe_dir(tmp_path_factory.mktemp("bpe"), request.param)
    return ttok.HfTokenizer(path), jtok.HfTokenizer(path)


def test_hf_tokenizer_matches_the_jax_one(pair):
    port, ref = pair
    assert port.byte_exact is ref.byte_exact is False
    assert port.eos_id == ref.eos_id >= 0
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text)
        assert port.encode_plain(text) == ref.encode_plain(text)
        ids = ref.encode_plain(text)
        assert port.decode(ids) == ref.decode(ids)
        assert port.decode(ids + [port.eos_id]) == ref.decode(
            ids + [ref.eos_id])
    for chat in CHATS:
        assert list(port.apply_chat(chat)) == list(ref.apply_chat(chat))


def test_byte_tokenizer_matches_the_jax_one():
    port, ref = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    assert (port.vocab_size, port.eos_id, port.byte_exact) == \
        (ref.vocab_size, ref.eos_id, ref.byte_exact)
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text)
        assert port.encode_plain(text) == ref.encode_plain(text)
        ids = ref.encode(text) + [256, 300]
        assert port.decode(ids) == ref.decode(ids)
    for chat in CHATS:
        assert port.apply_chat(chat) == ref.apply_chat(chat)
    assert ttok._chat_fallback_text(CHATS[1]) == \
        jtok._chat_fallback_text(CHATS[1])


def test_get_tokenizer(tmp_path):
    assert ttok.get_tokenizer("") is None
    assert ttok.get_tokenizer(None) is None
    assert isinstance(ttok.get_tokenizer("bytes"), ttok.ByteTokenizer)
    pytest.importorskip("transformers")
    tok = ttok.get_tokenizer(_build_bpe_dir(tmp_path))
    assert isinstance(tok, ttok.HfTokenizer)
