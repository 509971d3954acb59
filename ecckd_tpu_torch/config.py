"""Configuration language compatible with ecCKD's ``readconfig``.

Implements the config syntax of the reference (documented in
doc/ecckd_documentation.tex:672-737; C implementation
src/tools/readconfig.c, API src/include/readconfig.h:23-204):

* whitespace-separated ``param value`` lines, ``#`` comments
* quoted (``"``/``'``) multi-token values that may span lines, and
  ``{ ... }`` brace-delimited values with embedded comments
  (readconfig.c:637-691)
* nested ``\\begin section ... \\end [section]`` scoping flattened to
  ``section.sub.param`` with one level popped per ``\\end``
  (readconfig.c:700-765)
* ``\\include file`` with paths resolved relative to the including file
  and self-inclusion rejected (readconfig.c:766-841)
* ``$name`` whole-value references substituting a previously registered
  parameter (readconfig.c:464-478)
* ``(a b c[2][3]) v1 v2 ...`` tables distributing tokens round-robin over
  the named columns, with ``[m][n]`` matrix dims (readconfig.c:180-407)
* bare parameters registering the value ``"1"`` (REPLACE_VALUE,
  readconfig.c:53-56); case-insensitive parameter lookup
  (readconfig.c:136-150)
* command-line ``key=value`` overrides, ``-flag`` booleans and positional
  file registration under numeric keys (rc_register_args/rc_register_files,
  readconfig.c:884-1005)
* typed readers with C ``strtod``/``strtol`` prefix-parse semantics and
  vectors that stop at the first non-numeric token (readconfig.c:1712-1779)
* ``sprint()`` provenance rendering in the reference's rc_sprint format
  (``param=value`` pairs joined by ``"; "``, whitespace-compressed values
  wrapped in ``{}``, readconfig.c:1122-1272) — this exact string is what
  the reference embeds as the ``config`` attribute of every output file
  (DataFileEngineCfg.cpp:441, ckd_model.cpp:510)

This is a typed Python re-design (entry list + case-folded index), not a
port of the C linked-list code; quirks of the C parser that are observable
through its API are reproduced deliberately and cited inline.

The port's own copy of ``ecckd_tpu/config.py``: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import os
import re
import shlex
from typing import Any, Dict, List, Optional, Sequence

COMMENT_CHAR = "#"
SECTION_CHAR = "."
ESCAPE_CHAR = "\\"
REFERENCE_CHAR = "$"


class ConfigError(ValueError):
    pass


# ---------------------------------------------------------------------------
# C-style numeric prefix parsing (strtod / strtol semantics)
# ---------------------------------------------------------------------------

_STRTOD_RE = re.compile(
    r"[ \t\n\r\f\v]*([+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
    r"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?"
    r"|[nN][aA][nN]))")
_STRTOL_RE = re.compile(r"[ \t\n\r\f\v]*([+-]?\d+)")


def _strtod(s: str):
    """Parse a leading double like C strtod: (value, chars_consumed) or
    (None, 0) when no conversion is possible."""
    m = _STRTOD_RE.match(s)
    if not m:
        return None, 0
    return float(m.group(1)), m.end()


def _strtol(s: str):
    """Parse a leading base-10 integer like C strtol (stops at '.', 'e'...)."""
    m = _STRTOL_RE.match(s)
    if not m:
        return None, 0
    return int(m.group(1)), m.end()


def _substrings(value: str) -> List[str]:
    """Split a value into whitespace-separated tokens where ``{...}`` and
    ``"..."`` group multi-word tokens (delimiters stripped), mirroring
    rc_substring/rc_count_substrings (readconfig.c:1505-1616)."""
    out: List[str] = []
    i, n = 0, len(value)
    while i < n:
        while i < n and value[i] <= " ":
            i += 1
        if i >= n:
            break
        c = value[i]
        if c == "{" or c == '"':
            close = "}" if c == "{" else '"'
            j = value.find(close, i + 1)
            if j < 0:
                out.append(value[i + 1:])
                i = n
            else:
                out.append(value[i + 1:j])
                i = j + 1
        else:
            j = i
            while j < n and value[j] > " ":
                j += 1
            out.append(value[i:j])
            i = j
    return out


def _compress_ws(s: str) -> str:
    """__rc_copy_compress_whitespace: strip + collapse runs to one space."""
    return " ".join(s.split())


class _Entry:
    __slots__ = ("param", "value", "m", "n")

    def __init__(self, param: str, value: str, m: int = 0, n: int = 0):
        self.param = param
        self.value = value
        self.m = m
        self.n = n


def _split_dims(param: str):
    """Strip a ``[m][n]`` suffix from a parameter name (readconfig.c:432-462).

    Only positive leading integers count; malformed dims leave 0."""
    br = param.find("[")
    if br < 0:
        return param, 0, 0
    rest = param[br + 1:]
    name = param[:br]
    m = n = 0
    val, used = _strtol(rest)
    if val is not None and val > 0:
        m = val
    if used:
        rest = rest[used:]
        nxt = rest.find("[")
        if nxt >= 0:
            val, used2 = _strtol(rest[nxt + 1:])
            if val is not None and val > 0:
                n = val
    return name, m, n


# ---------------------------------------------------------------------------
# Character-level scanner mirroring rc_append (readconfig.c:552-880)
# ---------------------------------------------------------------------------

class _Scanner:
    """fgetc/ungetc-style cursor over config text."""

    def __init__(self, text: str):
        self.t = text
        self.i = 0
        self.n = len(text)

    def getc(self) -> str:
        """Return next char, or '' at EOF (keeps returning '' like fgetc)."""
        if self.i >= self.n:
            return ""
        c = self.t[self.i]
        self.i += 1
        return c

    def ungetc(self, c: str) -> None:
        if c != "" and self.i > 0:
            self.i -= 1

    def skip_line(self) -> str:
        """Advance past the next newline; return '\\n' or '' (EOF)."""
        while True:
            c = self.getc()
            if c == "\n" or c == "":
                return c

    def skip_whitespace(self) -> str:
        """Return first char that is not non-newline whitespace; stops at
        '\\n' and EOF like __rc_skip_whitespace."""
        while True:
            c = self.getc()
            if c == "" or c == "\n" or c > " ":
                return c


class Config:
    """readconfig-compatible key/value store with typed readers.

    Mirrors the reference ``DataFile``-backed Cfg engine interface used by
    all pipeline executables (ref: src/tools/DataFileEngineCfg.cpp:60-83):
    construct from ``argv`` to combine positional file registration, a
    config file and ``key=value`` overrides, or from a file/text/dict
    directly.
    """

    def __init__(self, data: Optional[Dict[str, str]] = None):
        self._entries: List[_Entry] = []
        # lowercase param -> FIRST entry with that name (C list search
        # returns the first match, readconfig.c:136-150)
        self._index: Dict[str, _Entry] = {}
        self._section: Optional[str] = None  # section_reqd during parse
        self._source_files: List[str] = []
        if data:
            for k, v in data.items():
                self._register(k, str(v))

    # ------------------------------------------------------------------
    # Registration core (mirrors __rc_register, readconfig.c:409-532)
    # ------------------------------------------------------------------
    def _find(self, param: str) -> Optional[_Entry]:
        return self._index.get(param.lower())

    def _register(self, param: str, value: Optional[str],
                  use_section: bool = True) -> None:
        param, m, n = _split_dims(param)
        # $reference substitution: whole-value only (readconfig.c:464-478);
        # unresolved references keep the literal "$name" value.
        if value and value[0] == REFERENCE_CHAR:
            ref = self._find(value[1:])
            if ref is not None:
                value = ref.value
        section = self._section if use_section else None
        if section:
            # Reproduced C quirk (readconfig.c:484-492): with a section in
            # force the overwrite comparison tests ".param" against "param"
            # and never matches, so re-registering a key inside \begin/\end
            # APPENDS a duplicate; lookups keep returning the first.
            full = f"{section}{SECTION_CHAR}{param}"
            entry = _Entry(full, value if value is not None else "1", m, n)
            self._entries.append(entry)
            self._index.setdefault(full.lower(), entry)
            return
        existing = self._find(param)
        if existing is not None:
            # REPLACE_VALUE: value replaced, dims untouched
            existing.value = value if value is not None else "1"
            return
        entry = _Entry(param, value if value is not None else "1", m, n)
        self._entries.append(entry)
        self._index[param.lower()] = entry

    def _register_table(self, params: str, value: Optional[str]) -> None:
        """Mirror __rc_register_table (readconfig.c:180-407): round-robin
        token distribution over the bracketed column names."""
        section = self._section
        cols: List[_Entry] = []
        i, n = 0, len(params)
        while i < n:
            while i < n and params[i] <= " ":
                i += 1
            if i >= n:
                break
            j = i
            while j < n and params[j] > " " and params[j] != "[":
                j += 1
            name = params[i:j]
            m_dim = n_dim = 0
            if j < n and params[j] == "[":
                _, m_dim, n_dim = _split_dims(params[i:])
                while j < n and params[j] > " ":
                    j += 1
            if section:
                name = f"{section}{SECTION_CHAR}{name}"
            entry = self._find(name)
            if entry is not None:
                entry.value = ""
                entry.m, entry.n = m_dim, n_dim
            else:
                entry = _Entry(name, "", m_dim, n_dim)
                self._entries.append(entry)
                self._index[name.lower()] = entry
            cols.append(entry)
            i = j
        if not cols:
            raise ConfigError(
                "No param names found in brackets of table assignment")
        if value is None:
            return
        # Distribute value tokens (braced/quoted groups kept verbatim,
        # including their delimiters) round-robin across columns; each
        # appended token is preceded by a space (readconfig.c:344-383).
        i, n, icol = 0, len(value), 0
        while i < n:
            while i < n and value[i] <= " ":
                i += 1
            if i >= n:
                break
            c = value[i]
            if c == "{" or c == '"':
                close = "}" if c == "{" else '"'
                j = value.find(close, i + 1)
                j = n if j < 0 else j + 1
            else:
                j = i
                while j < n and value[j] > " ":
                    j += 1
            cols[icol].value += " " + value[i:j]
            icol = (icol + 1) % len(cols)
            i = j

    # ------------------------------------------------------------------
    # Parser (mirrors rc_append, readconfig.c:552-880)
    # ------------------------------------------------------------------
    def _append_text(self, text: str, file_name: str = "") -> None:
        s = _Scanner(text)
        while True:
            c = s.skip_whitespace()
            if c == "":
                break
            if c == COMMENT_CHAR:
                s.skip_line()
                continue
            if c == "\n":
                continue
            if c == "(":
                # Table of objects: param collects up to ')'
                chars = []
                while c != ")":
                    c = s.getc()
                    if c == "":
                        raise ConfigError(
                            "File ended before table column names finished: "
                            f"\"({''.join(chars)}\"")
                    chars.append(c)
                param = "(" + "".join(chars[:-1])
            else:
                chars = []
                while c > " " and c != COMMENT_CHAR and c != "":
                    chars.append(c)
                    c = s.getc()
                s.ungetc(c)
                param = "".join(chars)

            # Value
            value: Optional[str] = None
            c = s.skip_whitespace()
            if c == COMMENT_CHAR:
                s.skip_line()
            elif c != "\n" and c != "":
                if c == "'" or c == '"':
                    quote = c
                    chars = []
                    c = s.getc()
                    while c != "" and c != quote:
                        chars.append(c)
                        c = s.getc()
                    value = "".join(chars) or None
                elif c == "{":
                    chars = []
                    c = s.getc()
                    while c != "" and c != "}":
                        if c == COMMENT_CHAR:
                            s.skip_line()
                        else:
                            chars.append(c)
                        c = s.getc()
                    value = "".join(chars) or None
                else:
                    chars = []
                    while c != "" and c != "\n":
                        if c == COMMENT_CHAR:
                            s.skip_line()
                            break
                        if c != "\r":
                            chars.append(c)
                        c = s.getc()
                    value = "".join(chars).rstrip() or None

            # Special commands
            if param.startswith(ESCAPE_CHAR):
                cmd = param.lower()
                if cmd == "\\begin":
                    if value is None:
                        raise ConfigError("\\begin without section name")
                    self._section = (value if self._section is None
                                     else f"{self._section}"
                                          f"{SECTION_CHAR}{value}")
                elif cmd == "\\end":
                    if self._section is None:
                        raise ConfigError('"\\end" with no "\\begin"')
                    head, _, last = self._section.rpartition(SECTION_CHAR)
                    if value is not None and last.lower() != value.lower():
                        raise ConfigError(
                            f'"\\begin {last}" ended by "\\end {value}"')
                    self._section = head or None
                elif cmd == "\\include":
                    if value is None:
                        raise ConfigError("\\include does not specify a file")
                    path = value
                    if not path.startswith("/") and file_name:
                        path = os.path.join(os.path.dirname(file_name), path)
                    if path == file_name:
                        raise ConfigError(
                            f"{file_name} attempts to \\include itself")
                    with open(path) as f:
                        self._append_text(f.read(), path)
                    self._source_files.append(path)
                # Unknown \commands are ignored (readconfig.c:843-851)
            elif param.startswith("("):
                self._register_table(param[1:], value)
            else:
                self._register(param, value)

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_text(cls, text: str, file_name: str = "") -> "Config":
        cfg = cls()
        cfg._append_text(text, file_name)
        if cfg._section is not None:
            raise ConfigError(
                f'Section "{cfg._section}" unterminated by \\end')
        cfg._section = None
        return cfg

    @classmethod
    def from_file(cls, path: str) -> "Config":
        """Extension-dispatched load (ref DataFile format dispatch,
        src/tools/DataFile.cpp:76-110: cfg→Cfg engine, xml→Xml engine)."""
        if path.endswith(".xml"):
            return cls.from_xml(path)
        with open(path) as f:
            cfg = cls.from_text(f.read(), path)
        cfg._source_files.append(path)
        return cfg

    @classmethod
    def from_xml(cls, path: str) -> "Config":
        """Read a config from an XML document: element nesting maps to the
        dotted-section namespace, element text (whitespace-separated) to
        values, exactly as ``\\begin sec … \\end sec`` does in the cfg
        language.

        The reference's XML engine (src/tools/DataFileEngineXml.cpp) is only
        built against the proprietary GMV ECSL library (#ifdef HAVE_GMVECSL)
        and is absent from default builds; this standalone reader keeps the
        same DataFile-facade semantics without that dependency, including
        the GMV dialect's name mapping (DataFileEngineXml.cpp:82-113
        ``translate_varname``): unsectioned names live in a top-level
        ``<main>`` group (``read("x")`` finds ``<main><x>``), dotted names
        map to element nesting (``a.b`` -> ``<a><b>``), and element tags may
        themselves contain dots (``a.b.c.d`` -> ``<a><b><c.d>``).
        """
        import xml.etree.ElementTree as ET

        root = ET.parse(path).getroot()
        cfg = cls()

        def walk(elem, prefix):
            text = (elem.text or "").strip()
            if text:
                cfg._register(prefix, " ".join(text.split()))
            for child in elem:
                walk(child, f"{prefix}.{child.tag}" if prefix
                     else child.tag)

        for child in root:
            if child.tag == "main":
                # GMV scope rule: <main> holds the unsectioned namespace.
                for sub in child:
                    walk(sub, sub.tag)
            else:
                walk(child, child.tag)
        cfg._source_files.append(path)
        return cfg

    @classmethod
    def from_args(cls, args: Sequence[str], prog: str = "") -> "Config":
        """Build config from CLI args, mirroring the Cfg engine constructor
        (DataFileEngineCfg.cpp:60-83):

        1. positional (non ``key=value``, non ``-flag``) args registered
           under numeric keys ``"1"``, ``"2"``, ... with ``prog`` (argv[0])
           as ``"0"`` (rc_register_files, readconfig.c:955-1005)
        2. each positional arg parsed as a config file (the reference parses
           only the first ``.cfg`` arg, rc_get_file; accepting every
           positional file is a compatible superset used by the tools here)
        3. ``key=value`` overrides and ``-flag`` booleans registered last so
           they beat file values (rc_register_args, readconfig.c:898-948);
           ``key=$name`` substitutes an already-registered value and is
           skipped when unresolved
        """
        cfg = cls()
        files: List[str] = []
        cfg._register("0", prog if prog else "ecckd_tpu")
        nfiles = 1
        for arg in args:
            if arg.startswith("-") and len(arg) > 1:
                continue
            if "=" not in arg:
                cfg._register(str(nfiles), arg)
                nfiles += 1
                files.append(arg)
        for path in files:
            sub = cls.from_file(path)
            for e in sub._entries:
                cfg._register(f"{e.param}[{e.m}][{e.n}]"
                              if e.m or e.n else e.param, e.value)
            cfg._source_files.extend(sub._source_files)
        for arg in args:
            if arg.startswith("-") and len(arg) > 1:
                # "-flag" registers flag with value "1"
                cfg._register(arg[1:], None)
                continue
            # The C scans for EVERY '=' in the argument, registering one
            # pair per occurrence (readconfig.c:907-943): "a=b=c" sets both
            # a="b=c" and "a=b"="c".  Reproduced for fidelity; only the
            # first is ever meaningful.
            for pos, ch in enumerate(arg):
                if ch != "=" or pos == 0:
                    continue
                key = arg[:pos]
                val = arg[pos + 1:]
                if val.startswith(REFERENCE_CHAR):
                    ref = cfg._find(val[1:])
                    if ref is None:
                        continue  # unresolved: skip entirely
                    val = ref.value
                cfg._register(key, val)
        return cfg

    # ------------------------------------------------------------------
    # Typed readers.  All return (value, True) style via default sentinel:
    # read(key) raises if missing unless a default is given.
    # ------------------------------------------------------------------
    _MISSING = object()

    def exist(self, key: str) -> bool:
        return self._find(key) is not None

    def _raw(self, key: str, default: Any = _MISSING) -> Optional[str]:
        entry = self._find(key)
        if entry is not None:
            return entry.value
        if default is self._MISSING:
            raise ConfigError(f"Config key {key!r} not found")
        return default

    def read_string(self, key: str, index: Optional[int] = None,
                    default: Any = _MISSING) -> Optional[str]:
        """Read a string; with ``index``, the i'th whitespace-separated
        token, where ``{...}``/``"..."`` group multi-word tokens
        (rc_get_substring, readconfig.c:1620-1632).

        Returns None when index is past the end of the list (this is how the
        reference iterates lists of unknown length, e.g. ``gases``,
        ``training_input``).
        """
        raw = self._raw(key, default)
        if raw is None:
            return None
        if index is None:
            return raw.rstrip() if raw else raw  # rc_get_string trailing-ws
        toks = _substrings(raw)
        if index < 0 or index >= len(toks):
            return None
        return toks[index]

    def read_strings(self, key: str,
                     default: Any = _MISSING) -> Optional[List[str]]:
        raw = self._raw(key, default)
        if raw is None or isinstance(raw, list):
            return raw
        return _substrings(raw)

    def read_float(self, key: str, default: Any = _MISSING,
                   index: Optional[int] = None) -> Optional[float]:
        """Read a number; with ``index``, the i'th element of a
        space-separated list (ref rc_get_real_element,
        readconfig.c:1760-1781; returns None past the end).  Follows C
        strtod prefix semantics: ``"2.5m"`` reads 2.5."""
        raw = self._raw(key, default)
        if raw is None or isinstance(raw, (int, float)):
            return raw
        if index is not None:
            toks = _substrings(raw)
            if index < 0 or index >= len(toks):
                return None
            raw = toks[index]
        val, used = _strtod(raw)
        if val is None:
            raise ConfigError(f"Config key {key!r} is not a number: {raw!r}")
        return val

    def read_int(self, key: str, default: Any = _MISSING,
                 index: Optional[int] = None) -> Optional[int]:
        """C strtol semantics (rc_get_int, readconfig.c:1323-1346):
        base-10 prefix parse, so ``"3.7"`` reads 3."""
        raw = self._raw(key, default)
        if raw is None or isinstance(raw, int):
            return raw
        if index is not None:
            toks = _substrings(str(raw))
            if index < 0 or index >= len(toks):
                return None
            raw = toks[index]
        val, used = _strtol(str(raw))
        if val is None:
            raise ConfigError(
                f"Config key {key!r} is not an integer: {raw!r}")
        return val

    def read_bool(self, key: str, default: Any = _MISSING) -> Optional[bool]:
        """rc_get_boolean semantics (readconfig.c:1285-1316): a present
        bare parameter is true; values starting with "false"/"no" (case
        insensitive) are false; otherwise numeric zero is false and
        anything else (including non-numeric strings) is true."""
        raw = self._raw(key, default)
        if raw is None or isinstance(raw, bool):
            return raw
        tok = str(raw).strip().lower()
        if tok.startswith("false") or tok.startswith("no"):
            return False
        val, used = _strtod(str(raw))
        if val is None:
            return True
        return val != 0.0

    def read_floats(self, key: str,
                    default: Any = _MISSING) -> Optional[List[float]]:
        """rc_get_real_vector (readconfig.c:1747-1779): repeated strtod,
        stopping at the first token that does not parse."""
        raw = self._raw(key, default)
        if raw is None or isinstance(raw, list):
            return raw
        out: List[float] = []
        rest = str(raw)
        while rest:
            val, used = _strtod(rest)
            if val is None:
                break
            out.append(val)
            rest = rest[used:]
        return out

    def read_ints(self, key: str,
                  default: Any = _MISSING) -> Optional[List[int]]:
        raw = self._raw(key, default)
        if raw is None or isinstance(raw, list):
            return raw
        out: List[int] = []
        rest = str(raw)
        while rest:
            val, used = _strtol(rest)
            if val is None:
                break
            out.append(val)
            rest = rest[used:]
        return out

    def read_matrix(self, key: str,
                    default: Any = _MISSING) -> Optional[List[List[float]]]:
        """2-D matrix declared as ``key[m][n]`` (rc_get_real_matrix,
        readconfig.c:1796-1837): m*n must match the number of values."""
        entry = self._find(key)
        if entry is None:
            if default is self._MISSING:
                raise ConfigError(f"Config key {key!r} not found")
            return default
        vals = self.read_floats(key)
        if entry.m * entry.n != len(vals):
            raise ConfigError(
                f"Matrix {key!r} should have {entry.m}*{entry.n}="
                f"{entry.m * entry.n} elements but found {len(vals)}")
        return [vals[i * entry.n:(i + 1) * entry.n] for i in range(entry.m)]

    def size(self, key: str):
        """(n_substrings, m, n) like rc_size (readconfig.c:1655-1671).

        Reproduced C quirk: rc_count_substrings returns 0 — not the count —
        when the value ends in whitespace (the end-of-string check inside
        its skip-whitespace loop, readconfig.c:1578-1584), which is the case
        for every ``{...}``-braced and table-built value.  read_strings()
        tokenizes correctly regardless."""
        entry = self._find(key)
        if entry is None:
            return 0, 0, 0
        val = entry.value
        if not val or val[-1] <= " ":
            return 0, entry.m, entry.n
        return len(_substrings(val)), entry.m, entry.n

    def set(self, key: str, value: Any) -> None:
        if isinstance(value, (list, tuple)):
            self._register(key, " ".join(str(v) for v in value))
        else:
            self._register(key, str(value))

    def section(self, name: str) -> "Config":
        """Sub-config of all ``name.*`` keys with the prefix stripped."""
        prefix = (name + SECTION_CHAR).lower()
        sub = Config()
        for e in self._entries:
            if e.param.lower().startswith(prefix):
                sub._register(e.param[len(prefix):], e.value)
                if e.m or e.n:
                    ent = sub._entries[-1]
                    ent.m, ent.n = e.m, e.n
        return sub

    def keys(self) -> List[str]:
        return [e.param for e in self._entries]

    # ------------------------------------------------------------------
    # Provenance
    # ------------------------------------------------------------------
    def sprint(self) -> str:
        """Render in the reference rc_sprint format (readconfig.c:1122-1272,
        non-SPRINT_CLASSIC build): ``param=value`` pairs joined by ``"; "``,
        values containing whitespace wrapped in ``{}`` with internal
        whitespace compressed, ``[m][n]`` dims appended to matrix names.
        This is the string embedded as the ``config`` attribute of every
        reference output file (DataFileEngineCfg.cpp:441)."""
        parts = []
        for e in self._entries:
            name = e.param
            if e.m > 0 or e.n > 0:
                name += f"[{e.m}][{e.n}]"
            val = e.value
            if any(ch <= " " for ch in val):
                val = "{" + _compress_ws(val) + "}"
            parts.append(f"{name}={val}")
        return "; ".join(parts)

    def serialize(self) -> str:
        """Render the full config as parseable cfg-language text (one
        ``param value`` per line, whitespace-bearing values quoted)."""
        lines = []
        for e in self._entries:
            name = e.param
            if e.m > 0 or e.n > 0:
                name += f"[{e.m}][{e.n}]"
            val = e.value
            if re.search(r"\s", val) or not val:
                val = '"' + val + '"'
            lines.append(f"{name} {val}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"Config({len(self._entries)} keys)"


def command_line_string(argv: Sequence[str]) -> str:
    """Reconstruct a command line for the provenance ``history`` attribute."""
    return " ".join(shlex.quote(a) if re.search(r"\s", a) else a for a in argv)
