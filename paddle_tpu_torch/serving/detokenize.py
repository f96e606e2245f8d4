"""Incremental streaming detokenization over TokenEvents.

Counterpart of paddle_tpu/serving/detokenize.py, kept as a copy (host
code only; the port imports nothing of the JAX package). A byte-level
tokenizer splits one multi-byte UTF-8 character across several tokens,
so decoding each token as it arrives would emit replacement characters
at every split. `StreamDetokenizer` buffers raw bytes until a
byte-complete boundary and only then releases text. It needs a token ->
bytes mapping (``id_to_bytes(tok)``, else ``decode([tok])``);
`TokenizerAdapter` derives one from a HuggingFace-style tokenizer
(``convert_ids_to_tokens``). ``ServingEngine.stream_text`` keeps one
detokenizer per request.
"""

from __future__ import annotations

from typing import List


def complete_utf8_prefix(buf: bytes) -> int:
    """Length of the longest prefix of ``buf`` that does not end in the
    middle of a multi-byte UTF-8 character. Malformed tails (stray
    continuation bytes, over-long runs) count as complete: the decode
    replaces them, the right surface for broken token bytes."""
    i = len(buf)
    j = i
    while j > 0 and i - j < 3 and (buf[j - 1] & 0xC0) == 0x80:
        j -= 1                       # skip trailing continuation bytes
    if j == 0:
        return i                     # all continuations: malformed, emit
    lead = buf[j - 1]
    if lead < 0x80:
        return i                     # ASCII tail: complete
    if lead >= 0xF0:
        need = 4
    elif lead >= 0xE0:
        need = 3
    elif lead >= 0xC0:
        need = 2
    else:
        return i                     # stray continuation byte: emit
    return i if i - (j - 1) >= need else j - 1


def _byte_decoder() -> dict:
    """Inverse of the GPT-2 byte-level BPE `bytes_to_unicode` table: the
    printable ASCII / latin bytes map to themselves, the other byte
    values to code points past 0x100, and byte-level vocabularies are
    spelled in that alphabet, so a token string maps back to raw bytes
    one character at a time."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(0x100 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


class TokenizerAdapter:
    """Makes a HuggingFace-style tokenizer streamable: derives
    ``id_to_bytes`` from ``convert_ids_to_tokens``.

      * byte-level BPE pieces (over the bytes_to_unicode alphabet) are
        inverted exactly, so a token holding part of a multi-byte
        character yields its partial bytes;
      * SentencePiece pieces (leading U+2581) map the marker to a space
        and encode the rest;
      * anything else is encoded as UTF-8.

    `StreamDetokenizer` wraps tokenizers in it where they need it."""

    _SP_MARKER = "▁"

    def __init__(self, tokenizer):
        if tokenizer is None:
            raise ValueError("TokenizerAdapter needs a tokenizer object")
        self.tokenizer = tokenizer
        self._decoder = _byte_decoder()

    @classmethod
    def wrap(cls, tokenizer):
        """Adapt ``tokenizer`` only if it needs it: objects with
        id_to_bytes pass through, objects with convert_ids_to_tokens are
        wrapped, decode-only objects keep `token_bytes`' decode path."""
        if tokenizer is None or hasattr(tokenizer, "id_to_bytes"):
            return tokenizer
        if hasattr(tokenizer, "convert_ids_to_tokens"):
            return cls(tokenizer)
        return tokenizer

    def id_to_bytes(self, tok: int) -> bytes:
        piece = self.tokenizer.convert_ids_to_tokens(int(tok))
        if isinstance(piece, (list, tuple)):
            piece = piece[0] if piece else ""
        if piece is None:
            piece = ""
        if isinstance(piece, bytes):
            return piece
        piece = str(piece)
        if piece and all(c in self._decoder for c in piece):
            return bytes(self._decoder[c] for c in piece)
        if piece.startswith(self._SP_MARKER):
            piece = " " + piece[len(self._SP_MARKER):]
        return piece.encode("utf-8")

    def decode(self, ids):
        return self.tokenizer.decode(ids)


def token_bytes(tokenizer, tok: int) -> bytes:
    """Raw bytes of one token id: ``id_to_bytes`` where the tokenizer has
    it (it can return partial UTF-8 sequences), else ``decode([tok])``
    (str or bytes)."""
    if hasattr(tokenizer, "id_to_bytes"):
        return bytes(tokenizer.id_to_bytes(int(tok)))
    out = tokenizer.decode([int(tok)])
    return out if isinstance(out, bytes) else str(out).encode("utf-8")


class StreamDetokenizer:
    """Per-request incremental detokenizer.

    d = StreamDetokenizer(tokenizer)
    d.push(tok)        # -> newly completed text ('' while buffering)
    d.push_event(ev)   # same, from a TokenEvent (flushes when finished)
    d.finish()         # flush the remainder (errors -> U+FFFD)
    d.text             # everything emitted so far
    d.consumed         # tokens pushed so far (the engine's resume cursor)
    """

    def __init__(self, tokenizer):
        self.tokenizer = TokenizerAdapter.wrap(tokenizer)
        self._pending = b""
        self._parts: List[str] = []
        self.consumed = 0
        self.finished = False

    @property
    def text(self) -> str:
        return "".join(self._parts)

    def push(self, tok: int) -> str:
        """Feed one token; returns the text it releases (the longest
        byte-complete prefix of the pending bytes)."""
        if self.finished:
            raise ValueError("push() after finish()")
        self.consumed += 1
        self._pending += token_bytes(self.tokenizer, tok)
        cut = complete_utf8_prefix(self._pending)
        if not cut:
            return ""
        out = self._pending[:cut].decode("utf-8", errors="replace")
        self._pending = self._pending[cut:]
        self._parts.append(out)
        return out

    def push_event(self, event) -> str:
        """Feed one engine TokenEvent; a finished event also flushes."""
        out = self.push(event.token)
        if getattr(event, "finished", False):
            out += self.finish()
        return out

    def finish(self) -> str:
        """End of stream: release the pending bytes, an incomplete
        trailing sequence replaced."""
        self.finished = True
        if not self._pending:
            return ""
        out = self._pending.decode("utf-8", errors="replace")
        self._pending = b""
        self._parts.append(out)
        return out
