"""Minimal self-contained PDF text extraction (no third-party deps).

The reference extracts PDF text with pdfium and applies title/date
heuristics (reference seekstorm_server ingest.rs:79-156, 430-459).  This
environment has neither pdfium nor pypdf, so this module implements the
subset of ISO 32000 needed for text extraction:

* object scanning (robust against broken xref tables: objects are located
  by scanning for `N G obj ... endobj`),
* compressed object streams (/ObjStm) and FlateDecode,
* the page tree and page /Contents streams,
* text operators (BT/ET, Tj, TJ, ', ", Td/TD/T*/Tm) with PDF string
  syntax (escapes, octal, hex strings),
* per-font /ToUnicode CMaps (bfchar + bfrange, 1- and 2-byte codes) so
  embedded-subset fonts decode to real text; fonts without a CMap fall
  back to Latin-1.

Not supported (rare for text documents): encrypted PDFs, LZW/DCT-coded
content streams, Type3 glyph programs.
"""

from __future__ import annotations

import re
import zlib


# ---------------------------------------------------------------------------
# object model: a tiny recursive-descent parser for PDF syntax

class Ref:
    __slots__ = ("num",)

    def __init__(self, num: int):
        self.num = num

    def __repr__(self):
        return f"Ref({self.num})"


_WS = b"\x00\t\n\f\r "
_DELIM = b"()<>[]{}/%"


class _Parser:
    def __init__(self, data: bytes, pos: int = 0):
        self.d = data
        self.i = pos

    def _skip_ws(self):
        d, i, n = self.d, self.i, len(self.d)
        while i < n:
            c = d[i : i + 1]
            if c in (b"%",):  # comment to EOL
                while i < n and d[i] not in b"\r\n":
                    i += 1
            elif c in _WS:
                i += 1
            else:
                break
        self.i = i

    def parse(self):
        self._skip_ws()
        d, i = self.d, self.i
        if i >= len(d):
            return None
        c = d[i : i + 1]
        if c == b"<":
            if d[i + 1 : i + 2] == b"<":
                return self._dict()
            return self._hexstring()
        if c == b"(":
            return self._litstring()
        if c == b"[":
            return self._array()
        if c == b"/":
            return self._name()
        if c in b"+-.0123456789":
            return self._number_or_ref()
        # keywords
        m = re.match(rb"(true|false|null)", d[i:])
        if m:
            self.i += m.end()
            return {b"true": True, b"false": False, b"null": None}[m.group(1)]
        self.i += 1
        return None

    def _name(self):
        d = self.d
        i = self.i + 1
        out = bytearray()
        while i < len(d) and d[i : i + 1] not in _WS and d[i : i + 1] not in _DELIM:
            if d[i : i + 1] == b"#" and i + 2 < len(d):
                out.append(int(d[i + 1 : i + 3], 16))
                i += 3
            else:
                out.append(d[i])
                i += 1
        self.i = i
        return b"/" + bytes(out)

    def _number_or_ref(self):
        d = self.d
        m = re.match(rb"[+-]?(\d+\.\d*|\.\d+|\d+)", d[self.i:])
        tok = m.group(0)
        self.i += m.end()
        if b"." in tok:
            return float(tok)
        # lookahead for "G R" (indirect reference)
        m2 = re.match(rb"\s+(\d+)\s+R\b", d[self.i:])
        if m2 and tok.isdigit():
            self.i += m2.end()
            return Ref(int(tok))
        return int(tok)

    def _array(self):
        self.i += 1
        out = []
        while True:
            self._skip_ws()
            if self.i >= len(self.d) or self.d[self.i : self.i + 1] == b"]":
                self.i += 1
                return out
            out.append(self.parse())

    def _dict(self):
        self.i += 2
        out = {}
        while True:
            self._skip_ws()
            if self.d[self.i : self.i + 2] == b">>":
                self.i += 2
                return out
            if self.i >= len(self.d):
                return out
            key = self.parse()
            val = self.parse()
            if isinstance(key, bytes):
                out[key] = val

    def _litstring(self):
        d = self.d
        i = self.i + 1
        depth = 1
        out = bytearray()
        while i < len(d):
            c = d[i]
            if c == 0x5C:  # backslash
                i += 1
                if i >= len(d):
                    break
                e = d[i : i + 1]
                if e in b"nrtbf":
                    out.append({b"n": 10, b"r": 13, b"t": 9, b"b": 8,
                                b"f": 12}[e])
                    i += 1
                elif e in b"01234567":
                    oct_ = d[i : i + 3]
                    m = re.match(rb"[0-7]{1,3}", oct_)
                    out.append(int(m.group(0), 8) & 0xFF)
                    i += m.end()
                elif e in b"\r\n":
                    i += 1
                    if e == b"\r" and d[i : i + 1] == b"\n":
                        i += 1
                else:
                    out.append(d[i])
                    i += 1
            elif c == 0x28:  # (
                depth += 1
                out.append(c)
                i += 1
            elif c == 0x29:  # )
                depth -= 1
                if depth == 0:
                    i += 1
                    break
                out.append(c)
                i += 1
            else:
                out.append(c)
                i += 1
        self.i = i
        return bytes(out)

    def _hexstring(self):
        d = self.d
        j = d.index(b">", self.i)
        hexs = re.sub(rb"[^0-9A-Fa-f]", b"", d[self.i + 1 : j])
        if len(hexs) % 2:
            hexs += b"0"
        self.i = j + 1
        return bytes.fromhex(hexs.decode())


def _parse_obj(data: bytes):
    return _Parser(data).parse()


# ---------------------------------------------------------------------------
# document

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b")


class PdfDocument:
    def __init__(self, data: bytes):
        self.data = data
        self.objs: dict[int, bytes] = {}       # raw object body
        self._parsed: dict[int, object] = {}
        self._scan_objects()
        self._expand_object_streams()

    # -- object access ------------------------------------------------------

    def _scan_objects(self):
        d = self.data
        for m in _OBJ_RE.finditer(d):
            end = d.find(b"endobj", m.end())
            if end < 0:
                end = len(d)
            self.objs[int(m.group(1))] = d[m.end():end]

    def obj(self, x):
        """Resolve an object: Ref -> parsed value, else passthrough."""
        while isinstance(x, Ref):
            num = x.num
            if num in self._parsed:
                x = self._parsed[num]
                continue
            body = self.objs.get(num)
            v = _parse_obj(body) if body is not None else None
            self._parsed[num] = v
            x = v
        return x

    def stream_of(self, num_or_ref) -> bytes | None:
        """Decoded stream content of an object."""
        num = num_or_ref.num if isinstance(num_or_ref, Ref) else num_or_ref
        body = self.objs.get(num)
        if body is None:
            return None
        sd = _parse_obj(body)
        if not isinstance(sd, dict):
            return None
        m = re.search(rb"stream\r?\n", body)
        if not m:
            return None
        start = m.end()
        end = body.rfind(b"endstream")
        if end < 0:
            end = len(body)
        raw = body[start:end].rstrip(b"\r\n")
        ln = self.obj(sd.get(b"/Length"))
        if isinstance(ln, int) and 0 < ln <= len(raw):
            raw = raw[:ln]
        filt = self.obj(sd.get(b"/Filter"))
        filters = filt if isinstance(filt, list) else ([filt] if filt else [])
        for f in filters:
            f = self.obj(f)
            if f == b"/FlateDecode":
                try:
                    raw = zlib.decompress(raw)
                except zlib.error:
                    try:
                        raw = zlib.decompressobj().decompress(raw)
                    except zlib.error:
                        return None
            elif f in (b"/ASCIIHexDecode",):
                raw = bytes.fromhex(
                    re.sub(rb"[^0-9A-Fa-f]", b"", raw.rstrip(b">")).decode())
            elif f is None:
                pass
            else:
                return None  # unsupported filter (DCT, LZW, ...)
        return raw

    def _expand_object_streams(self):
        """Pull objects out of /ObjStm compressed object streams."""
        for num in list(self.objs):
            body = self.objs[num]
            if b"/ObjStm" not in body:
                continue
            sd = _parse_obj(body)
            if not isinstance(sd, dict) or sd.get(b"/Type") != b"/ObjStm":
                continue
            content = self.stream_of(num)
            if content is None:
                continue
            n = self.obj(sd.get(b"/N")) or 0
            first = self.obj(sd.get(b"/First")) or 0
            header = content[:first].split()
            for k in range(min(n, len(header) // 2)):
                onum = int(header[2 * k])
                off = int(header[2 * k + 1])
                nxt = (int(header[2 * k + 3])
                       if 2 * k + 3 < len(header) else len(content) - first)
                if onum not in self.objs:
                    self.objs[onum] = content[first + off : first + nxt]
                    self._parsed.pop(onum, None)

    # -- page tree ------------------------------------------------------------

    def pages(self) -> list[dict]:
        out = []
        for num, body in self.objs.items():
            if b"/Page" not in body:
                continue
            v = self.obj(Ref(num))
            if isinstance(v, dict) and v.get(b"/Type") == b"/Page":
                out.append(v)
        return out

    def info(self) -> dict:
        for num, body in self.objs.items():
            if b"/Title" in body or b"/CreationDate" in body:
                v = self.obj(Ref(num))
                if isinstance(v, dict) and (
                    b"/Title" in v or b"/CreationDate" in v
                ):
                    if v.get(b"/Type") in (None,):
                        return v
        return {}


# ---------------------------------------------------------------------------
# ToUnicode CMaps

def _parse_tounicode(cmap: bytes) -> dict[int, str]:
    out: dict[int, str] = {}

    def u16s(b: bytes) -> str:
        try:
            return b.decode("utf-16-be", errors="ignore")
        except Exception:
            return ""

    for m in re.finditer(rb"beginbfchar(.*?)endbfchar", cmap, re.S):
        toks = re.findall(rb"<([0-9A-Fa-f]+)>", m.group(1))
        for src, dst in zip(toks[0::2], toks[1::2]):
            out[int(src, 16)] = u16s(bytes.fromhex(dst.decode()))
    for m in re.finditer(rb"beginbfrange(.*?)endbfrange", cmap, re.S):
        body = m.group(1)
        i = 0
        p = _Parser(body)
        while True:
            p._skip_ws()
            if p.i >= len(body):
                break
            a = p.parse()
            b = p.parse()
            c = p.parse()
            if not isinstance(a, bytes) or not isinstance(b, bytes):
                break
            lo = int.from_bytes(a, "big")
            hi = int.from_bytes(b, "big")
            if isinstance(c, list):
                for k, dst in enumerate(c):
                    if isinstance(dst, bytes):
                        out[lo + k] = u16s(dst)
            elif isinstance(c, bytes):
                base = int.from_bytes(c, "big")
                for k in range(hi - lo + 1):
                    out[lo + k] = chr(base + k)
            i += 1
            if i > 65536:
                break
    return out


# ---------------------------------------------------------------------------
# content-stream text extraction

_CS_TOKEN = re.compile(
    rb"\((?:\\.|[^\\()])*\)|<<|>>|<[0-9A-Fa-f\s]*>|/[^\s()<>\[\]{}/%]*"
    rb"|[+-]?(?:\d+\.\d*|\.\d+|\d+)|\[|\]|[A-Za-z'\"*]+"
)


def _page_fonts(doc: PdfDocument, page: dict) -> dict[bytes, dict[int, str]]:
    """Per-font-name ToUnicode maps + code width for the page."""
    res = doc.obj(page.get(b"/Resources")) or {}
    fonts = doc.obj(res.get(b"/Font")) or {}
    out = {}
    for name, fref in fonts.items() if isinstance(fonts, dict) else ():
        fd = doc.obj(fref)
        if not isinstance(fd, dict):
            continue
        tu = fd.get(b"/ToUnicode")
        cmap = doc.stream_of(tu) if tu is not None else None
        two_byte = fd.get(b"/Subtype") == b"/Type0"
        out[name] = {
            "map": _parse_tounicode(cmap) if cmap else None,
            "two_byte": two_byte,
        }
    return out


def _decode_string(raw: bytes, font) -> str:
    if font and font.get("map") is not None:
        m = font["map"]
        step = 2 if font.get("two_byte") else 1
        out = []
        for i in range(0, len(raw) - step + 1, step):
            code = int.from_bytes(raw[i : i + step], "big")
            out.append(m.get(code, ""))
        return "".join(out)
    return raw.decode("latin-1", errors="ignore")


def _extract_page_text(doc: PdfDocument, page: dict) -> str:
    contents = doc.obj(page.get(b"/Contents"))
    refs = contents if isinstance(contents, list) else [page.get(b"/Contents")]
    data = b""
    for r in refs:
        if r is None:
            continue
        s = doc.stream_of(r) if isinstance(r, Ref) else None
        if s:
            data += s + b"\n"
    if not data:
        return ""

    fonts = _page_fonts(doc, page)
    cur_font = None
    out: list[str] = []
    stack: list = []
    for m in _CS_TOKEN.finditer(data):
        tok = m.group(0)
        c = tok[:1]
        if c == b"(":
            stack.append(_Parser(tok).parse())
        elif c == b"<" and tok != b"<<":
            stack.append(_Parser(tok).parse())
        elif c == b"/":
            stack.append(tok)
        elif c in b"+-.0123456789":
            stack.append(float(tok))  # numbers never decode as text (TJ)
        elif tok == b"[":
            stack.append(tok)
        elif tok == b"]":
            # collect array content back to [
            arr = []
            while stack and stack[-1] != b"[":
                arr.append(stack.pop())
            if stack:
                stack.pop()
            arr.reverse()
            stack.append(arr)
        elif tok == b"Tf":
            if len(stack) >= 2 and isinstance(stack[-2], bytes) \
                    and stack[-2][:1] == b"/":
                cur_font = fonts.get(stack[-2])
            stack.clear()
        elif tok == b"Tj" or tok == b"'" or tok == b'"':
            if stack and isinstance(stack[-1], bytes):
                out.append(_decode_string(stack[-1], cur_font))
            if tok in (b"'", b'"'):
                out.append("\n")
            stack.clear()
        elif tok == b"TJ":
            if stack and isinstance(stack[-1], list):
                for el in stack[-1]:
                    if isinstance(el, bytes) and el[:1] not in b"/":
                        out.append(_decode_string(el, cur_font))
            stack.clear()
        elif tok in (b"Td", b"TD", b"T*"):
            out.append("\n")
            stack.clear()
        elif tok == b"ET":
            out.append("\n")
            stack.clear()
        elif tok in (b"BT", b"Tm", b"Tc", b"Tw", b"Tz", b"TL", b"Ts", b"Tr"):
            stack.clear()
    text = "".join(out)
    # normalize whitespace runs but keep line structure
    text = re.sub(r"[ \t]+", " ", text)
    text = re.sub(r"\n{3,}", "\n\n", text)
    return text.strip()


# ---------------------------------------------------------------------------
# public API

def extract_text(data: bytes) -> tuple[str, dict]:
    """(full text, metadata) from PDF bytes.

    Metadata keys (when present): title, creation_date — the same fields
    the reference's heuristics feed (ingest.rs:430-459); when the Info
    dictionary has no title, the first non-empty text line is used."""
    doc = PdfDocument(data)
    pages = doc.pages()
    text = "\n\n".join(
        t for t in (_extract_page_text(doc, p) for p in pages) if t
    )
    meta: dict = {}
    info = doc.info()
    title = info.get(b"/Title")
    if isinstance(title, bytes) and title.strip():
        if title[:2] in (b"\xfe\xff",):
            meta["title"] = title[2:].decode("utf-16-be", errors="ignore")
        else:
            meta["title"] = title.decode("latin-1", errors="ignore")
    cd = info.get(b"/CreationDate")
    if isinstance(cd, bytes):
        m = re.match(rb"D:(\d{4})(\d{2})?(\d{2})?", cd)
        if m:
            meta["creation_date"] = "-".join(
                g.decode() for g in m.groups() if g
            )
    if "title" not in meta:
        for line in text.split("\n"):
            if line.strip():
                meta["title"] = line.strip()[:200]
                break
    return text, meta
