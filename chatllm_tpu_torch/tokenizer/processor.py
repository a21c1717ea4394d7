"""Byte-exact BPE tokenizers (pure Python).

Copy of `BPEProcessor1` (SentencePiece-score merges: Llama-2, Mistral),
`BPEProcessor2` (byte-level BPE with merge ranks) and the vocab machinery
they need from the JAX package's tokenizer, with two changes that keep it
free of packages outside the standard library:

  - the merges run in Python only (no native merge engine);
  - the pre-split regexes use `re` instead of the `regex` package.  `re` has
    no `\\p{..}` classes and its `\\s` also matches U+001C..U+001F, so
    `compile_unicode_regex` rewrites `\\p{X}` into explicit code-point
    ranges built from `unicodedata`, and `\\s`/`\\S` into the Unicode
    White_Space set that `regex` uses.

Parity anchors: chatllm.cpp src/tokenizer.cpp (llama_sp_tokenizer:54,
llm_bpe_tokenizer:492, load_vocab_list:330, Processor::Encode:225).
"""
from __future__ import annotations

import functools
import heapq
import re
import unicodedata
from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# vocab
# ---------------------------------------------------------------------------


class TokenType:
    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


@dataclass
class TokenRecord:
    tok: bytes
    score: float = 0.0
    type: int = TokenType.NORMAL


@dataclass
class Vocab:
    token_to_id: dict[bytes, int] = field(default_factory=dict)
    id_to_token: list[TokenRecord] = field(default_factory=list)
    special_tokens: dict[int, bytes] = field(default_factory=dict)
    bpe_ranks: dict[tuple[bytes, bytes], int] = field(default_factory=dict)
    byte_fallback_tok_ids: list[int] = field(default_factory=lambda: [-1] * 256)
    byte_fallback_ready: bool = False

    def find_bpe_rank(self, left: bytes, right: bytes) -> int:
        return self.bpe_ranks.get((left, right), -1)

    def is_normal(self, tid: int) -> bool:
        return 0 <= tid < len(self.id_to_token) and self.id_to_token[tid].type == TokenType.NORMAL

    def is_control(self, tid: int) -> bool:
        return 0 <= tid < len(self.id_to_token) and self.id_to_token[tid].type == TokenType.CONTROL


def load_vocab_list(vocab: Vocab, reader, has_score: bool, has_type: bool, start_id: int = 0) -> int:
    """Parse the vocab records written by the converter (format:
    chatllm.cpp convert.py write_vocab; byte-fallback detection:
    src/tokenizer.cpp:330-379)."""
    count = 0
    byte_fallback_started = False
    last_byte = -1
    while True:
        ln = reader.i32()
        if ln < 0:
            break
        tid = start_id + count
        word = reader.read(ln)
        score = reader.f32() if has_score else 0.0
        ttype = reader.u8() if has_type else TokenType.NORMAL

        flag = False
        if len(word) == 1:
            ch = word[0]
            if not byte_fallback_started and ch == 0:
                byte_fallback_started = True
                last_byte = -1
            if byte_fallback_started:
                if ch == last_byte + 1:
                    last_byte = ch
                    vocab.byte_fallback_tok_ids[last_byte] = tid
                    flag = True
                else:
                    byte_fallback_started = False
        if not flag:
            vocab.token_to_id[word] = tid
        while len(vocab.id_to_token) <= tid:
            vocab.id_to_token.append(TokenRecord(b""))
        vocab.id_to_token[tid] = TokenRecord(word, score, ttype)
        count += 1
    for i in range(last_byte + 1):
        vocab.token_to_id.setdefault(bytes([i]), vocab.byte_fallback_tok_ids[i])
    if last_byte == 255:
        vocab.byte_fallback_ready = True
    return count


def load_vocab_merges(vocab: Vocab, reader) -> int:
    count = 0
    while True:
        ln = reader.i32()
        if ln < 0:
            break
        word = reader.read(ln)
        pos = word.find(b" ", 1)
        if pos >= 0:
            vocab.bpe_ranks[(word[:pos], word[pos + 1 :])] = count
        count += 1
    return count


# ---------------------------------------------------------------------------
# utf-8 walking (the reference walks possibly-invalid utf8 with a lookup
# table; we mirror that so malformed bytes split identically)
# ---------------------------------------------------------------------------

_UTF8_LEN = [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4]


def utf8_char_lengths(data: bytes) -> list[int]:
    out = []
    off = 0
    n = len(data)
    while off < n:
        ln = min(n - off, _UTF8_LEN[data[off] >> 4])
        out.append(ln)
        off += ln
    return out


# ---------------------------------------------------------------------------
# GPT-2 byte-level mapping
# ---------------------------------------------------------------------------

def _build_byte_maps():
    b2u = {}
    for ch in list(range(0x21, 0x7F)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)):
        b2u[ch] = chr(ch)
    n = 0
    for ch in range(256):
        if ch not in b2u:
            b2u[ch] = chr(256 + n)
            n += 1
    u2b = {v: k for k, v in b2u.items()}
    return b2u, u2b


BYTE_TO_UNICODE, UNICODE_TO_BYTE = _build_byte_maps()


def byte_level_encode(data: bytes) -> bytes:
    """raw bytes -> byte-level token text (utf-8 of mapped chars)."""
    return "".join(BYTE_TO_UNICODE[b] for b in data).encode("utf-8")


def byte_level_decode(text: bytes) -> bytes:
    """byte-level token text -> raw bytes (unmappable chars pass through)."""
    out = bytearray()
    for ch in text.decode("utf-8", errors="replace"):
        b = UNICODE_TO_BYTE.get(ch)
        if b is None:
            out.extend(ch.encode("utf-8"))
        else:
            out.append(b)
    return bytes(out)



# ---------------------------------------------------------------------------
# `regex`-compatible patterns on the standard `re` module
# ---------------------------------------------------------------------------

# Unicode White_Space (PropList.txt), which is what `regex` matches for \s
_WHITE_SPACE = ("\\t\\n\\x0b\\x0c\\r\\x20\\x85\\xa0\\u1680\\u2000-\\u200a"
                "\\u2028\\u2029\\u202f\\u205f\\u3000")


def _esc(cp: int) -> str:
    return f"\\U{cp:08x}"


# Code points past U+323FF other than the U+E0000 tag block carry no letter,
# number or punctuation in any Unicode version to date (planes 4-13 are
# unassigned, 15-16 private use), so the scan stops there.
_SCAN = (range(0x32400), range(0xE0000, 0xE1000))


@functools.lru_cache(maxsize=None)
def _category_ranges(cat: str) -> str:
    """Class body (no brackets) of every code point whose general category
    starts with `cat` (\\p{L}, \\p{N}, \\p{P}, ...)."""
    out = []
    for span in _SCAN:
        lo = None
        for cp in span:
            hit = unicodedata.category(chr(cp)).startswith(cat)
            if hit and lo is None:
                lo = cp
            elif not hit and lo is not None:
                out.append(_esc(lo) if lo == cp - 1 else f"{_esc(lo)}-{_esc(cp - 1)}")
                lo = None
        if lo is not None:
            out.append(f"{_esc(lo)}-{_esc(span[-1])}")
    return "".join(out)


def translate_regex(pattern: str) -> str:
    """Rewrite a `regex`-dialect pattern (\\p{X}, Unicode \\s) into `re`."""
    out = []
    in_class = False
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            n = pattern[i + 1]
            if n == "p" and pattern.startswith("{", i + 2):
                j = pattern.index("}", i + 3)
                body = _category_ranges(pattern[i + 3:j])
                out.append(body if in_class else f"[{body}]")
                i = j + 1
                continue
            if n == "s":
                out.append(_WHITE_SPACE if in_class else f"[{_WHITE_SPACE}]")
            elif n == "S" and not in_class:
                out.append(f"[^{_WHITE_SPACE}]")
            elif n == "S":
                raise ValueError(f"\\S inside a class is not supported: {pattern}")
            else:
                out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            if pattern.startswith("^", i + 1):
                out.append("^")
                i += 1
            if pattern.startswith("]", i + 1):      # literal ] first in class
                out.append("\\]")
                i += 1
        elif c == "]" and in_class:
            in_class = False
            out.append(c)
        else:
            out.append(c)
        i += 1
    return "".join(out)


def compile_unicode_regex(pattern: str) -> re.Pattern:
    return re.compile(translate_regex(pattern))


# ---------------------------------------------------------------------------
# special-token trie (faithful to NearestKeywordSearcher semantics,
# src/tokenizer.cpp:712-818: only leaf keywords match; earliest position wins)
# ---------------------------------------------------------------------------


class KeywordSearcher:
    def __init__(self, keywords: dict[int, bytes]):
        self.root: dict = {}
        for tid, kw in keywords.items():
            node = self.root
            for b in kw:
                node = node.setdefault(b, {})
            node["id"] = tid

    def _match(self, data: bytes, index: int) -> tuple[int, int]:
        """Returns (token_id, length) matching at index, walking until a
        leaf; -1 if none (keywords that are strict prefixes of others only
        match through their longest extension — reference quirk)."""
        node = self.root
        level = 0
        while True:
            children = [k for k in node if k != "id"]
            if not children:
                return node.get("id", -1), level
            if index >= len(data):
                return -1, 0
            b = data[index]
            if b not in node:
                return -1, 0
            node = node[b]
            index += 1
            level += 1

    def split(self, data: bytes):
        """Yield (leading_bytes, token_id) pieces; final piece has id=-1."""
        while True:
            idx = 0
            found = -1
            ln = 0
            while idx < len(data):
                found, ln = self._match(data, idx)
                if found >= 0:
                    break
                idx += 1
            if found >= 0:
                yield data[:idx], found
                data = data[idx + ln :]
            else:
                yield data, -1
                return


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------


class Processor:
    def __init__(self):
        self.vocab = Vocab()
        self.piece_size = 0
        self.id_unk_token = -1
        self.token_unk_id = "<?>"
        self.ret_special_token = False
        self.pp: list = []
        self.token_override: dict[int, str] = {}
        self.added_tokens: list[tuple[str, int]] = []

    # -- loading -----------------------------------------------------------
    def load(self, reader, n_vocab: int) -> int:
        raise NotImplementedError

    # -- encode/decode -----------------------------------------------------
    def _do_encode(self, text: bytes, ids: list[int]):
        raise NotImplementedError

    def encode(self, text: str) -> list[int]:
        s = text
        for p in self.pp:
            s = p.transform(s)
        ids: list[int] = []
        data = s
        # added-token split: earliest occurrence of any added token wins
        # (src/tokenizer.cpp:225-262)
        while True:
            special_pos = None
            special_id = -1
            special_len = 0
            for tok, tid in self.added_tokens:
                pos = data.find(tok)
                if pos >= 0 and (special_pos is None or pos < special_pos):
                    special_pos = pos
                    special_id = tid
                    special_len = len(tok)
            if special_pos is None:
                break
            self._do_encode(data[:special_pos].encode("utf-8"), ids)
            data = data[special_pos + special_len :]
            ids.append(special_id)
        self._do_encode(data.encode("utf-8"), ids)
        return ids

    def decode(self, ids: list[int]) -> str:
        return b"".join(self.id_to_piece_bytes(i) for i in ids).decode("utf-8", errors="replace")

    def id_to_piece_bytes(self, tid: int) -> bytes:
        if tid in self.token_override:
            return self.token_override[tid].encode("utf-8")
        if tid < 0:
            return self.token_unk_id.encode("utf-8")
        if tid < len(self.vocab.id_to_token):
            return self.vocab.id_to_token[tid].tok
        return self.token_unk_id.encode("utf-8")

    def id_to_piece(self, tid: int) -> str:
        return self.id_to_piece_bytes(tid).decode("utf-8", errors="replace")

    def piece_to_id(self, piece: str) -> int:
        for tok, tid in self.added_tokens:
            if tok == piece:
                return tid
        return self.vocab.token_to_id.get(piece.encode("utf-8"), self.id_unk_token)

    # -- config ------------------------------------------------------------
    def register_preprocessor(self, prep):
        self.pp.append(prep)

    def override_token_decoding(self, tid: int, tok: str):
        if tid < 0:
            return
        self.token_override[tid] = tok

    def add_added_token(self, tok: str, tid: int):
        assert tid >= 0, f"add_added_token: {tok}, id={tid}"
        self.override_token_decoding(tid, tok)
        self.added_tokens.append((tok, tid))

    def enable_return_special_token(self, en: bool):
        self.ret_special_token = en

    def set_id_unknown_token(self, tid: int):
        self.id_unk_token = tid

    def get_piece_size(self) -> int:
        return self.piece_size

    def _finish_load(self):
        for rec_id, rec in enumerate(self.vocab.id_to_token):
            if rec.type != TokenType.NORMAL:
                self.vocab.special_tokens[rec_id] = rec.tok


class BPEProcessor1(Processor):
    """SentencePiece-score BPE (chatllm.cpp llama_sp_tokenizer parity): the
    text's utf-8 characters are merged pairwise, highest vocab score first
    (ties: the leftmost pair), while the merged bytes are a vocab piece.  A
    piece left over outside the vocab falls back to its bytes, token
    `byte + 3` each (llama.cpp's convention: ids 3..258 are <0x00>..<0xFF>).
    No pre-processor: spaces are plain bytes, as the converter writes the
    pieces' U+2581 as " "."""

    def load(self, reader, n_vocab: int) -> int:
        start = reader.off
        self.piece_size = load_vocab_list(self.vocab, reader, True, False, 0)
        del self.vocab.id_to_token[self.piece_size :]
        return reader.off - start

    def _do_encode(self, text: bytes, ids: list[int]):
        if not text:
            return
        v = self.vocab
        # symbols: (start, length) over the bytes, a linked list via prev / nxt
        lens = utf8_char_lengths(text)
        n = len(lens)
        start = []
        off = 0
        for ln in lens:
            start.append(off)
            off += ln
        length = lens[:]
        prev = list(range(-1, n - 1))
        nxt = [i + 1 if start[i] + length[i] < len(text) else -1 for i in range(n)]

        heap: list[tuple[float, int, int, int, int]] = []
        counter = 0

        def try_add_bigram(left: int, right: int):
            nonlocal counter
            if left == -1 or right == -1:
                return
            cand = text[start[left] : start[right] + length[right]]
            tid = v.token_to_id.get(cand)
            if tid is None or tid >= len(v.id_to_token):
                return
            # a max-heap on the score; ties: the smaller left index
            heapq.heappush(heap, (-v.id_to_token[tid].score, left, counter, right, len(cand)))
            counter += 1

        for i in range(1, n):
            try_add_bigram(i - 1, i)

        while heap:
            _, left, _, right, size = heapq.heappop(heap)
            if length[left] == 0 or length[right] == 0 or length[left] + length[right] != size:
                continue
            length[left] += length[right]
            length[right] = 0
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            try_add_bigram(prev[left], left)
            try_add_bigram(left, nxt[left])

        i = 0
        while i != -1:
            piece = text[start[i] : start[i] + length[i]]
            tid = v.token_to_id.get(piece)
            if tid is None:
                ids.extend(b + 3 for b in piece)
            else:
                ids.append(tid)
            i = nxt[i]


class BPEProcessor2(Processor):
    """HF byte-level BPE: regex pre-split, byte->unicode mapping, rank-based
    merges, ByteLevel or Sequence decoder."""

    DEFAULT_REGEXES = [
        r"[\p{P}\$\+<=>\^~\|]+",
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)",
        r"\p{N}+",
        r"[0-9][0-9][0-9]",
    ]

    DECODER_BYTE_LEVEL = 0
    DECODER_SEQUENCE = 1

    def __init__(self, regex_exprs: list[str] | None = None):
        super().__init__()
        self.regex_exprs = regex_exprs if regex_exprs is not None else self.DEFAULT_REGEXES
        self._compiled = [compile_unicode_regex(e) for e in self.regex_exprs]
        self.searcher: KeywordSearcher | None = None
        self.dec_type = self.DECODER_BYTE_LEVEL

    def set_decoder_type(self, t: int):
        self.dec_type = t

    def load(self, reader, n_vocab: int) -> int:
        start = reader.off
        self.piece_size = load_vocab_list(self.vocab, reader, False, True, 0)
        del self.vocab.id_to_token[self.piece_size :]
        load_vocab_merges(self.vocab, reader)
        self._finish_load()
        self.searcher = KeywordSearcher(self.vocab.special_tokens)
        return reader.off - start

    # regex split applied sequentially: each expr further splits the pieces
    def _regex_split(self, text: str) -> list[str]:
        pieces = [text]
        for creg in self._compiled:
            nxt = []
            for p in pieces:
                last = 0
                for m in creg.finditer(p):
                    if m.start() > last:
                        nxt.append(p[last : m.start()])
                    if m.end() > m.start():
                        nxt.append(p[m.start() : m.end()])
                    last = m.end()
                if last < len(p):
                    nxt.append(p[last:])
            pieces = nxt
        return pieces

    def _do_encode(self, text: bytes, ids: list[int]):
        if not text:
            return
        # split around special tokens appearing literally in the text
        for leading, sp_id in self.searcher.split(text):
            self._do_encode2(leading, ids)
            if sp_id >= 0:
                ids.append(sp_id)

    def _bpe_words(self, text: bytes) -> list[bytes]:
        words = self._regex_split(text.decode("utf-8", errors="replace"))
        if self.dec_type == self.DECODER_SEQUENCE:
            # Sequence decoder == raw-text vocab: the reference skips the
            # byte-level alphabet mapping entirely (BPEProcessor2::DoEncode2,
            # src/tokenizer.cpp:659-661 — mapping only for ByteLevel)
            return [w.encode("utf-8") for w in words]
        return [byte_level_encode(w.encode("utf-8")) for w in words]

    def _do_encode2(self, text: bytes, ids: list[int]):
        if not text:
            return
        words = self._bpe_words(text)
        self._merge_ranked(words, ids)

    def _merge_ranked(self, words: list[bytes], ids: list[int]):
        """Rank-queue BPE merge (llm_bpe_tokenizer parity: lower rank first,
        tie -> smaller left index), then byte-fallback to single mapped
        chars."""
        v = self.vocab
        for word in words:
            lens = utf8_char_lengths(word)
            n = len(lens)
            if n == 0:
                continue
            starts = []
            off = 0
            for ln in lens:
                starts.append(off)
                off += ln
            length = lens[:]
            prev = list(range(-1, n - 1))
            nxt = [i + 1 if starts[i] + length[i] < len(word) else -1 for i in range(n)]
            heap: list[tuple[int, int, bytes]] = []

            def add_bigram(left, right):
                if left == -1 or right == -1:
                    return
                lt = word[starts[left] : starts[left] + length[left]]
                rt = word[starts[right] : starts[right] + length[right]]
                rank = v.find_bpe_rank(lt, rt)
                if rank < 0:
                    return
                heapq.heappush(heap, (rank, left, right, lt + rt))

            for i in range(1, n):
                add_bigram(i - 1, i)

            while heap:
                rank, left, right, btext = heapq.heappop(heap)
                if length[left] == 0 or length[right] == 0:
                    continue
                cur = word[starts[left] : starts[left] + length[left]] + word[
                    starts[right] : starts[right] + length[right]
                ]
                if cur != btext:
                    continue
                length[left] += length[right]
                length[right] = 0
                nxt[left] = nxt[right]
                if nxt[right] >= 0:
                    prev[nxt[right]] = left
                add_bigram(prev[left], left)
                add_bigram(left, nxt[left])

            i = 0
            while i != -1:
                if length[i] > 0:
                    piece = word[starts[i] : starts[i] + length[i]]
                    tid = v.token_to_id.get(piece)
                    if tid is None:
                        # fallback: mapped chars (byte-level vocabs) or raw
                        # single bytes (Sequence/raw vocabs — the reference
                        # falls back per BYTE, tokenizer.cpp:603-609)
                        if self.dec_type == self.DECODER_SEQUENCE:
                            units = [piece[j:j + 1] for j in range(len(piece))]
                        else:
                            units = []
                            coff = 0
                            for cl in utf8_char_lengths(piece):
                                units.append(piece[coff:coff + cl])
                                coff += cl
                        for ch in units:
                            ctid = v.token_to_id.get(ch)
                            if ctid is None:
                                raise ValueError(f"byte not found in vocab: {ch!r}")
                            ids.append(ctid)
                    else:
                        ids.append(tid)
                i = nxt[i]

    def id_to_piece_bytes(self, tid: int) -> bytes:
        if tid in self.token_override:
            return self.token_override[tid].encode("utf-8")
        v = self.vocab
        if v.is_normal(tid):
            raw = v.id_to_token[tid].tok
            if self.dec_type == self.DECODER_BYTE_LEVEL:
                return byte_level_decode(raw)
            return raw
        if v.is_control(tid):
            return b""
        if self.ret_special_token and 0 <= tid < len(v.id_to_token):
            return v.id_to_token[tid].tok
        return b""
