"""Minimal binary FBX (7.x) parser — stdlib and numpy only (the port's own
copy of the JAX package's ``utils/fbx_parser.py``).

Replaces the Autodesk FBX SDK dependency of the reference
(CudaTest/src/Loader/FbxLoader.h) with a from-scratch reader of the documented
binary container: header "Kaydara FBX Binary  ", node records
(endOffset / numProperties / propertyListLen / name), and typed properties
(scalars Y,C,I,F,D,L; zlib-compressed arrays f,d,l,i,b; strings S; raw R).

This module is only the *container* layer; semantic extraction (mesh, skin,
animation) lives in fbx_loader.py.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

MAGIC = b"Kaydara FBX Binary  \x00"

# FBX time unit: 1 second == 46186158000 ticks ("KTime").
KTIME_PER_SECOND = 46186158000


@dataclass
class FbxNode:
    name: str
    props: List[Any] = field(default_factory=list)
    children: List["FbxNode"] = field(default_factory=list)

    def find(self, name: str) -> Optional["FbxNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> List["FbxNode"]:
        return [c for c in self.children if c.name == name]

    def __repr__(self):
        return f"FbxNode({self.name!r}, props={len(self.props)}, children={len(self.children)})"


_ARRAY_DTYPES = {
    b"f": np.float32, b"d": np.float64, b"l": np.int64, b"i": np.int32,
    b"b": np.uint8,
}


def _read_property(buf: memoryview, pos: int):
    code = bytes(buf[pos:pos + 1])
    pos += 1
    if code == b"Y":
        return struct.unpack_from("<h", buf, pos)[0], pos + 2
    if code == b"C":
        return bool(buf[pos]), pos + 1
    if code == b"I":
        return struct.unpack_from("<i", buf, pos)[0], pos + 4
    if code == b"F":
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if code == b"D":
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if code == b"L":
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if code in _ARRAY_DTYPES:
        n, enc, comp_len = struct.unpack_from("<III", buf, pos)
        pos += 12
        raw = bytes(buf[pos:pos + comp_len]) if enc else None
        dtype = _ARRAY_DTYPES[code]
        if enc:
            data = np.frombuffer(zlib.decompress(raw), dtype=dtype, count=n)
            pos += comp_len
        else:
            nbytes = n * np.dtype(dtype).itemsize
            data = np.frombuffer(bytes(buf[pos:pos + nbytes]), dtype=dtype, count=n)
            pos += nbytes
        return data, pos
    if code == b"S":
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        return bytes(buf[pos:pos + n]).decode("utf-8", "replace"), pos + n
    if code == b"R":
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        return bytes(buf[pos:pos + n]), pos + n
    raise ValueError(f"unknown FBX property type {code!r} at {pos}")


def parse_fbx(path: str) -> FbxNode:
    """Parse the file (binary OR ASCII FBX) into a root FbxNode tree."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(MAGIC):
        return parse_fbx_ascii(path)
    version = struct.unpack_from("<I", data, 23)[0]
    big = version >= 7500  # 64-bit record headers from 7.5
    buf = memoryview(data)

    def read_node(pos: int):
        if big:
            end, nprops, plen = struct.unpack_from("<QQQ", buf, pos)
            pos += 24
        else:
            end, nprops, plen = struct.unpack_from("<III", buf, pos)
            pos += 12
        name_len = buf[pos]
        pos += 1
        if end == 0 and nprops == 0 and name_len == 0:
            return None, pos  # null record (sentinel)
        name = bytes(buf[pos:pos + name_len]).decode("utf-8", "replace")
        pos += name_len
        node = FbxNode(name)
        for _ in range(nprops):
            v, pos = _read_property(buf, pos)
            node.props.append(v)
        while pos < end:
            child, pos = read_node(pos)
            if child is None:
                break
            node.children.append(child)
        return node, end

    root = FbxNode("<root>")
    pos = 27
    while pos < len(buf):
        node, pos = read_node(pos)
        if node is None:
            break
        root.children.append(node)
    root.props = [version]
    return root


# ---------------------------------------------------------------------------
# ASCII FBX
# ---------------------------------------------------------------------------

import re as _re

_KEY_RE = _re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*:\s*(.*)$")
_VALUE_RE = _re.compile(
    r'"((?:[^"\\]|\\.)*)"'                       # quoted string
    # Windows-exporter non-finite literals (3ds Max): 1.#QNAN, -1.#IND,
    # 1.#INF — must match BEFORE the plain number alternative or the
    # mantissa parses as a number and '#QNAN' leaks as a stray bare word
    r"|([+-]?1\.#(?:QNAN|IND|INF|SNAN)0*)"
    r"|([+-]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)"  # number
    r"|(\*\d+)"                                  # array count marker
    r"|([A-Za-z_][A-Za-z0-9_]*)"                 # bare word (Y, T, W, ...)
)


def _parse_ascii_values(text: str) -> List[Any]:
    """Comma-separated FBX ASCII value list -> python values."""
    out: List[Any] = []
    for m in _VALUE_RE.finditer(text):
        s, nonfin, num, count, word = m.groups()
        if s is not None:
            out.append(s)
        elif nonfin is not None:
            neg = nonfin.startswith("-")
            if "INF" in nonfin:
                out.append(float("-inf") if neg else float("inf"))
            else:
                out.append(float("nan"))
        elif num is not None:
            out.append(float(num) if any(c in num for c in ".eE")
                       else int(num))
        elif count is not None:
            pass            # "*N" array length marker — implied by the data
        else:
            out.append(word)
    return out


def _collapse_ascii_arrays(node: FbxNode) -> None:
    """Rewrite the ASCII `X: *N { a: v1,v2,... }` pattern into the binary
    form X.props == [ndarray], which is what fbx_loader consumes."""
    for c in node.children:
        _collapse_ascii_arrays(c)
    if len(node.children) == 1 and node.children[0].name == "a":
        vals = node.children[0].props
        isfloat = any(isinstance(v, float) for v in vals)
        node.props = [np.asarray(vals, np.float64 if isfloat else np.int64)]
        node.children = []


def parse_fbx_ascii(path: str) -> FbxNode:
    """Parse an ASCII FBX 7.x file into the same FbxNode tree shape as the
    binary reader (array containers collapsed to ndarray props), so the
    semantic layer (fbx_loader) is format-agnostic."""
    with open(path, "r", errors="replace") as f:
        lines = f.read().split("\n")
    first = next((ln for ln in lines if ln.strip()), "")
    if not (first.lstrip().startswith(";") or _KEY_RE.match(first)):
        raise ValueError(f"{path}: neither binary nor ASCII FBX")

    root = FbxNode("<root>")
    stack = [root]
    last_leaf: List[Optional[FbxNode]] = [None]

    for raw in lines:
        # strip full-line and trailing comments (';' never appears inside
        # FBX identifiers; a ';' inside a quoted string would be rare — cut
        # only when outside quotes)
        line = raw
        if ";" in line:
            q = False
            for i, ch in enumerate(line):
                if ch == '"':
                    q = not q
                elif ch == ";" and not q:
                    line = line[:i]
                    break
        line = line.strip()
        if not line:
            continue
        if line == "}":
            if len(stack) > 1:
                stack.pop()
                last_leaf.pop()
            continue
        m = _KEY_RE.match(line)
        if m:
            name, rest = m.groups()
            opens = rest.rstrip().endswith("{")
            if opens:
                rest = rest.rstrip()[:-1]
            node = FbxNode(name, _parse_ascii_values(rest))
            stack[-1].children.append(node)
            if opens:
                stack.append(node)
                last_leaf.append(None)
            else:
                last_leaf[-1] = node
        elif last_leaf[-1] is not None:
            # continuation of a wrapped value list (long `a:` arrays)
            last_leaf[-1].props.extend(_parse_ascii_values(line))

    _collapse_ascii_arrays(root)
    version = 0
    hdr = root.find("FBXHeaderExtension")
    if hdr is not None:
        v = hdr.find("FBXVersion")
        if v is not None and v.props:
            version = int(v.props[0])
    root.props = [version]
    return root


# ---------------------------------------------------------------------------
# Properties70 access
# ---------------------------------------------------------------------------

def get_prop70(node: FbxNode, name: str, default=None):
    """Read a Properties70/P entry: returns the value tuple tail (after the
    4 header strings) or a scalar if single-valued."""
    p70 = node.find("Properties70")
    if p70 is None:
        return default
    for p in p70.find_all("P"):
        if p.props and p.props[0] == name:
            vals = p.props[4:]
            if len(vals) == 1:
                return vals[0]
            return tuple(vals)
    return default


def get_vec3_prop(node: FbxNode, name: str, default=(0.0, 0.0, 0.0)):
    v = get_prop70(node, name, None)
    if v is None:
        return np.asarray(default, np.float64)
    if np.isscalar(v):            # single-valued P row (truncated files)
        return np.asarray([float(v)] * 3, np.float64)
    v = np.asarray(v, np.float64).reshape(-1)
    if v.shape[0] < 3:            # short row: pad with the default's tail
        v = np.concatenate([v, np.asarray(default, np.float64)[v.shape[0]:]])
    return v[:3]
