"""The port's stream detokenizer against the JAX package, on the CPU.

The pins of tests/test_serving_speculative.py (:359, :374, :393 and the
engine's stream_text) on the port's copy of serving/detokenize.py, the
`TokenizerAdapter` over byte-level BPE and SentencePiece pieces, and a
hypothesis property: on random streams of byte tokens (multi-byte UTF-8
characters split across tokens, stray and truncated sequences among
them) the port's `StreamDetokenizer` releases the same text at every push
as the JAX one, and `complete_utf8_prefix` gives the same cut.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu.serving import StreamDetokenizer as JaxStreamDetokenizer
from paddle_tpu.serving import TokenizerAdapter as JaxTokenizerAdapter
from paddle_tpu.serving import complete_utf8_prefix as jax_complete
from paddle_tpu_torch.serving import (
    SamplingParams, ServingEngine, StreamDetokenizer, TokenEvent,
    TokenizerAdapter, complete_utf8_prefix,
)
from test_torch_offload import TorchStubRunner


class ByteTableTokenizer:
    """Byte-level stub: id -> raw bytes, partial UTF-8 pieces included."""

    def __init__(self, table):
        self.table = table

    def id_to_bytes(self, tok):
        return self.table[int(tok) % len(self.table)]


def test_complete_utf8_prefix_boundaries():
    euro = "€".encode()
    assert complete_utf8_prefix(b"abc") == 3
    assert complete_utf8_prefix(b"ab" + euro[:1]) == 2
    assert complete_utf8_prefix(b"ab" + euro[:2]) == 2
    assert complete_utf8_prefix(b"ab" + euro) == 5
    emoji = "🎉".encode()
    for cut in range(1, 4):
        assert complete_utf8_prefix(emoji[:cut]) == 0
    assert complete_utf8_prefix(emoji) == 4
    assert complete_utf8_prefix(b"") == 0
    assert complete_utf8_prefix(b"\x82\x82") == 2


def test_stream_detokenizer_buffers_split_multibyte_tokens():
    euro = "€".encode()
    tok = ByteTableTokenizer({0: b"hi ", 1: euro[:1], 2: euro[1:2],
                              3: euro[2:], 4: b"!"})
    d = StreamDetokenizer(tok)
    assert d.push(0) == "hi "
    assert d.push(1) == ""
    assert d.push(2) == ""
    assert d.push(3) == "€"
    assert d.push(4) == "!"
    assert d.text == "hi €!"
    d2 = StreamDetokenizer(tok)
    d2.push(1)
    assert d2.finish() == "�"
    with pytest.raises(ValueError):
        d2.push(0)


def test_stream_detokenizer_decode_fallback_and_events():
    class StrTok:
        def decode(self, toks):
            return "".join(f"<{t}>" for t in toks)

    d = StreamDetokenizer(StrTok())
    assert d.push_event(TokenEvent("r", 7, 0)) == "<7>"
    assert d.push_event(TokenEvent("r", 8, 1, finished=True,
                                   finish_reason="stop")) == "<8>"
    assert d.finished and d.text == "<7><8>"


class HFStub:
    """convert_ids_to_tokens over a fixed piece list (HF style)."""

    def __init__(self, pieces):
        self.pieces = pieces

    def convert_ids_to_tokens(self, tok):
        return self.pieces[tok]

    def decode(self, ids):
        return "".join(self.pieces[i] for i in ids)


def test_tokenizer_adapter_inverts_byte_level_and_sentencepiece_pieces():
    """Byte-level BPE pieces map back to their raw (partial) bytes,
    SentencePiece's marker to a space, as the JAX adapter maps them."""
    # "é" is b"\xc3\xa9": byte-level pieces spell each byte as one char
    pieces = ["Ã", "©", "▁hello", "plain", "Ġworld"]
    ours, ref = (cls(HFStub(pieces)) for cls in (TokenizerAdapter,
                                                 JaxTokenizerAdapter))
    for i in range(len(pieces)):
        assert ours.id_to_bytes(i) == ref.id_to_bytes(i)
    assert ours.id_to_bytes(0) + ours.id_to_bytes(1) == "é".encode()
    assert ours.id_to_bytes(2) == b" hello"
    assert ours.id_to_bytes(4) == b" world"
    assert TokenizerAdapter.wrap(ByteTableTokenizer({0: b"x"})).table
    d = StreamDetokenizer(HFStub(pieces))
    assert isinstance(d.tokenizer, TokenizerAdapter)
    assert [d.push(0), d.push(1)] == ["", "é"]


def test_engine_stream_text_incremental():
    """The engine's stream_text over a byte table whose tokens 3 and 4
    split a euro sign: the text only ever appends, and the final text
    equals a one-shot decode of the tokens."""
    euro = "€".encode()
    table = {i: bytes([65 + i]) for i in range(31)}
    table[3] = euro[:2]
    table[4] = euro[2:]

    class Periodic(TorchStubRunner):
        def _logits(self, history):
            import torch
            nxt = (int(history[-2]) % self.vocab_size if len(history) >= 2
                   else (7 * (len(history) + 1)) % self.vocab_size)
            row = torch.zeros(self.vocab_size)
            row[nxt] = 1.0
            return row

    runner = Periodic(max_model_len=64)
    eng = ServingEngine(runner, num_blocks=20, max_batch_size=2,
                        max_model_len=64,
                        tokenizer=ByteTableTokenizer(table))
    rid = eng.add_request([3, 4, 3, 4], SamplingParams(max_tokens=8))
    seen = ""
    while eng.has_work():
        eng.step()
        cur = eng.stream_text(rid)
        assert cur.startswith(seen)
        seen = cur
    final = eng.stream_text(rid)
    assert eng.outputs()[rid].output_tokens == [3, 4] * 4
    assert final == "€" * 4
    with pytest.raises(ValueError):
        ServingEngine(runner, num_blocks=20, max_batch_size=2,
                      max_model_len=64).stream_text(rid)
    with pytest.raises(KeyError):
        eng.stream_text("nope")


# pieces of UTF-8: whole characters of 1-4 bytes, their fragments, and
# stray continuation / lead bytes
_CHARS = ["a", "é", "€", "🎉", "ж", "中"]
_PIECES = sorted({c.encode()[i:j] for c in _CHARS
                  for i in range(len(c.encode()))
                  for j in range(i + 1, len(c.encode()) + 1)}
                 | {b"\x80", b"\xbf", b"\xc3", b"\xf0\x9f", b" "})


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.integers(0, len(_PIECES) - 1), max_size=40),
       st.booleans())
def test_random_byte_streams_detokenize_as_jax_does(ids, finish):
    """Random byte-token streams: the port's detokenizer releases what
    the JAX one releases at every push (and at finish), and
    complete_utf8_prefix cuts every prefix of the stream where JAX's
    does."""
    table = dict(enumerate(_PIECES))
    ours = StreamDetokenizer(ByteTableTokenizer(table))
    ref = JaxStreamDetokenizer(ByteTableTokenizer(table))
    buf = b""
    for i in ids:
        assert ours.push(i) == ref.push(i)
        buf += table[i]
        assert complete_utf8_prefix(buf) == jax_complete(buf)
    if finish:
        assert ours.finish() == ref.finish()
        # finished, the streamed text is the whole stream's decode
        assert ours.text == buf.decode("utf-8", errors="replace")
    assert ours.text == ref.text and ours.consumed == ref.consumed
