"""The port's BPEProcessor1 (SentencePiece-score merges, pure Python)
encodes and decodes identically to the JAX package's, with the JAX
package's native merge engine off (CHATLLM_TPU_NATIVE_BPE=0: its pure-Python
merge, which the native one is held to), on two SentencePiece-score vocabs
in the converter's layout:

  - the narrow Llama-2 / Mistral vocab (`chip_smoke._sp_pieces`: <unk>,
    empty <s> and </s>, the 256 byte pieces at ids 3-258, scored pieces
    with spaces, CJK and "[INST]");
  - a vocab without byte pieces, where text outside the vocab falls back to
    ids byte + 3 whatever pieces they name.

Cases: ASCII, leading and repeated spaces, CJK, emoji, invalid-looking
byte runs, the pieces "<s>" / "[INST]" as text, added tokens, decoding of
the control and unknown ids; and a hypothesis fuzz with a fixed example
count."""
import struct

import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

import chip_smoke
from chatllm_tpu.ggmm.reader import SpanReader as JReader
from chatllm_tpu.tokenizer.processor import BPEProcessor1 as JBPE1
from chatllm_tpu_torch.ggmm.reader import SpanReader as TReader
from chatllm_tpu_torch.tokenizer.processor import BPEProcessor1


def _sp_blob(pieces) -> bytes:
    out = bytearray()
    for p, score in pieces:
        out += struct.pack("<i", len(p)) + p + struct.pack("<f", score)
    out += struct.pack("<i", -1)
    return bytes(out)


def _no_byte_pieces():
    """<unk>, <s>, </s>, the printable ASCII characters and a few merges: no
    byte-fallback run, so CJK and emoji fall back to ids byte + 3."""
    pieces = [(" ⁇ ".encode(), 0.0), (b"", 0.0), (b"", 0.0)]
    pieces += [(bytes([b]), -1.0) for b in range(32, 127)]
    pieces += [(t.encode(), -2.0 - i) for i, t in enumerate(
        (" t", "he", " the", "in", "ing", " a", "中", "中文", "  "))]
    return pieces


VOCABS = {"sp_bytes": chip_smoke._sp_pieces(384), "no_bytes": _no_byte_pieces()}


@pytest.fixture(scope="module", params=list(VOCABS))
def pair(request, monkeypatch_module):
    monkeypatch_module.setenv("CHATLLM_TPU_NATIVE_BPE", "0")
    blob = memoryview(_sp_blob(VOCABS[request.param]))
    j, t = JBPE1(), BPEProcessor1()
    assert j.load(JReader(blob, 0), 0) == t.load(TReader(blob, 0), 0)
    assert t.get_piece_size() == j.get_piece_size() == len(VOCABS[request.param])
    assert t.vocab.byte_fallback_ready == j.vocab.byte_fallback_ready == (
        request.param == "sp_bytes")
    return j, t


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


TEXTS = [
    "hello world", " hello world", "Hello  world", "   the end", "the", "",
    "[INST] what is 2024? [/INST]", "<s>[INST] hi [/INST]</s>", "中文 and 中", " 中文中文",
    "emoji 😀👍🏽 ok", "tab\tnew\nline\n\n", "µ ö ½ Ａ", "a" * 50, "the the the thing",
    "ring\x00zero\x7f", "▁spiece", "!\n!\n",
]


@pytest.mark.parametrize("text", range(len(TEXTS)))
def test_encode_decode_match_jax(pair, text):
    j, t = pair
    s = TEXTS[text]
    ids = t.encode(s)
    assert ids == j.encode(s)
    assert t.decode(ids) == j.decode(ids)
    if t.vocab.byte_fallback_ready:
        # byte pieces decode to their bytes: the round trip is exact
        assert t.decode(ids) == s


def test_merges_and_fallback(pair):
    j, t = pair
    ids = t.encode(" the 中文😀")
    if t.vocab.byte_fallback_ready:
        # " the" and "中文" are pieces; the emoji is 4 byte pieces
        assert t.decode(ids[:1]) == " the" and len(ids) == 1 + 2 + 4
        assert t.piece_to_id(" the") == ids[0]
    # bytes outside the vocab take id byte + 3 (llama.cpp's convention)
    assert ids[-4:] == [b + 3 for b in "😀".encode()]
    assert ids == j.encode(" the 中文😀")


def test_control_and_unknown_ids_decode_as_jax(pair):
    j, t = pair
    ids = [0, 1, 2, 3, 40, t.get_piece_size() - 1, t.get_piece_size() + 5, -1]
    assert [t.id_to_piece(i) for i in ids] == [j.id_to_piece(i) for i in ids]
    assert t.decode(ids) == j.decode(ids)
    assert t.piece_to_id("<s>") == j.piece_to_id("<s>")
    assert t.piece_to_id("[INST]") == j.piece_to_id("[INST]")


def test_added_tokens_split_as_jax(pair):
    j, t = pair
    for p in (j, t):
        p.add_added_token("<|tool|>", 7)
    s = "a<|tool|> the<|tool|>中"
    assert t.encode(s) == j.encode(s)
    assert t.encode(s).count(7) == 2
    for p in (j, t):
        p.added_tokens.clear()
        p.token_override.clear()


ALPHABET = list("the ing and hello world 2024 [INST]<s>/ \t\n") + [
    "中", "文", "µ", "ö", "😀", "👍", "▁", "\x00", "é", "ß"]


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.text(alphabet=st.sampled_from(ALPHABET), max_size=48))
def test_fuzz_matches_jax(pair, s):
    j, t = pair
    ids = t.encode(s)
    assert ids == j.encode(s)
    assert t.decode(ids) == j.decode(ids)
