"""openCypher lexer — cursor with one-token lookahead.

Token model follows the reference lexer's shape (graph/src/parser/lexer.rs
doc:9-56): keyword set, hex/octal/binary/scientific literals, line and block
comments, backtick-quoted identifiers, string escapes."""

from __future__ import annotations

import dataclasses

KEYWORDS = {
    "MATCH", "OPTIONAL", "WHERE", "RETURN", "CREATE", "MERGE", "DELETE",
    "DETACH", "SET", "REMOVE", "WITH", "UNWIND", "UNION", "ALL", "AS",
    "ORDER", "BY", "ASC", "ASCENDING", "DESC", "DESCENDING", "SKIP", "LIMIT",
    "DISTINCT", "AND", "OR", "XOR", "NOT", "IN", "IS", "NULL", "TRUE",
    "FALSE", "CALL", "YIELD", "CASE", "WHEN", "THEN", "ELSE", "END",
    "STARTS", "ENDS", "CONTAINS", "ON", "INDEX", "DROP", "FOR", "EXISTS",
    "FOREACH", "LOAD", "CSV", "FROM", "HEADERS", "FIELDTERMINATOR",
    "CYPHER", "COUNT",
    "VECTOR", "FULLTEXT", "RANGE", "REDUCE", "ANY", "NONE", "SINGLE",
    "CONSTRAINT", "ASSERT", "UNIQUE", "MANDATORY", "USING", "JOIN", "SCAN",
    "TO", "SHORTESTPATH", "ALLSHORTESTPATHS", "EXPLAIN", "PROFILE",
}

PUNCT = [
    "<>", "<=", ">=", "->", "<-", "=~", "..", "+=",
    "(", ")", "[", "]", "{", "}", ",", ".", ":", ";", "|", "=", "<", ">",
    "+", "-", "*", "/", "%", "^", "$",
]


@dataclasses.dataclass
class Token:
    kind: str  # 'kw' | 'ident' | 'int' | 'float' | 'string' | 'punct' | 'eof'
    value: object
    pos: int
    orig: object = None  # source spelling for kw tokens (labels like :End)

    def is_kw(self, *kws) -> bool:
        return self.kind == "kw" and self.value in kws

    def is_punct(self, *ps) -> bool:
        return self.kind == "punct" and self.value in ps


class LexError(ValueError):
    pass


def tokenize(text: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            if j < 0:
                raise LexError(f"unterminated block comment at {i}")
            i = j + 2
            continue
        if c in "\"'":
            j = i + 1
            buf = []
            while j < n and text[j] != c:
                if text[j] == "\\" and j + 1 < n:
                    esc = text[j + 1]
                    if esc in ("u", "U"):
                        # \uXXXX / \UXXXXXXXX code-point escapes; bad hex
                        # is a lex error (TCK Literals6 [10]/[13])
                        width = 4 if esc == "u" else 8
                        h = text[j + 2 : j + 2 + width]
                        if len(h) < width or any(
                                ch not in "0123456789abcdefABCDEF"
                                for ch in h):
                            raise LexError(
                                f"invalid unicode escape \\{esc}{h} at {j}")
                        buf.append(chr(int(h, 16)))
                        j += 2 + width
                        continue
                    buf.append({"n": "\n", "t": "\t", "r": "\r", "\\": "\\",
                                "'": "'", '"': '"', "0": "\0", "b": "\b",
                                "f": "\f"}.get(esc, esc))
                    j += 2
                else:
                    buf.append(text[j])
                    j += 1
            if j >= n:
                raise LexError(f"unterminated string at {i}")
            toks.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == "`":
            j = text.find("`", i + 1)
            if j < 0:
                raise LexError(f"unterminated backtick identifier at {i}")
            toks.append(Token("ident", text[i + 1 : j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            is_float = False
            if c == "0" and i + 1 < n and text[i + 1] in "xX":
                j = i + 2
                while j < n and (text[j] in "0123456789abcdefABCDEF"):
                    j += 1
                toks.append(Token("int", int(text[i:j], 16), i))
                i = j
                continue
            if c == "0" and i + 1 < n and text[i + 1] in "bB":
                j = i + 2
                while j < n and text[j] in "01":
                    j += 1
                toks.append(Token("int", int(text[i + 2 : j], 2), i))
                i = j
                continue
            if c == "0" and i + 1 < n and text[i + 1] in "oO":
                j = i + 2
                while j < n and text[j] in "01234567":
                    j += 1
                toks.append(Token("int", int(text[i + 2 : j], 8), i))
                i = j
                continue
            if c == "0" and i + 1 < n and text[i + 1].isdigit():
                # bare leading zero = octal literal (TCK Literals4), unless
                # it turns out to be a decimal float (01.5) or scientific
                j = i + 1
                while j < n and text[j].isdigit():
                    j += 1
                if not (j < n and (text[j] in "eE" or
                                   (text[j] == "." and
                                    text[j : j + 2] != ".."))):
                    lit = text[i:j]
                    if any(ch in "89" for ch in lit):
                        raise LexError(
                            f"invalid octal literal {lit!r} at {i}")
                    toks.append(Token("int", int(lit, 8), i))
                    i = j
                    continue
                j = i  # fall through to the decimal/float scanner
            while j < n and text[j].isdigit():
                j += 1
            # a '..' range operator must not be eaten as a float dot
            if j < n and text[j] == "." and not text[j : j + 2] == "..":
                if j + 1 < n and (text[j + 1].isdigit() or text[j + 1] in "eE"):
                    is_float = True
                    j += 1
                    while j < n and text[j].isdigit():
                        j += 1
            if j < n and text[j] in "eE":
                k = j + 1
                if k < n and text[k] in "+-":
                    k += 1
                if k < n and text[k].isdigit():
                    is_float = True
                    j = k
                    while j < n and text[j].isdigit():
                        j += 1
            lit = text[i:j]
            if is_float:
                f = float(lit)
                if f in (float("inf"), float("-inf")):
                    raise LexError(f"float literal out of range at {i}")
                toks.append(Token("float", f, i))
            else:
                toks.append(Token("int", int(lit), i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            word = text[i:j]
            up = word.upper()
            if up in KEYWORDS:
                toks.append(Token("kw", up, i, word))
            else:
                toks.append(Token("ident", word, i))
            i = j
            continue
        for p in PUNCT:
            if text.startswith(p, i):
                toks.append(Token("punct", p, i))
                i += len(p)
                break
        else:
            raise LexError(f"unexpected character {c!r} at {i}")
    toks.append(Token("eof", None, n))
    return toks
