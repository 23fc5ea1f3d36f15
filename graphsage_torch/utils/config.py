"""Configuration: HOCON parsing and flat dotted-key access.

Port of ``graphsage_tpu/utils/config.py`` (a copy: the port imports nothing
of the JAX package, not even its modules that need no JAX).  Same inputs
give the same ``Config`` and the same error messages, except a block on one
line, which the JAX parser misreads and this one rejects; the CLI's
``--config`` reads ``setting.num_layers`` and ``setting.hidden_emb_size``
from it (reference src/main.py:46,54).

``load_config`` delegates to pyhocon when it is importable, giving full
HOCON semantics (includes, concatenation, ``+=``).  Without pyhocon a
**HOCON-lite** parser takes over, with the subset the reference's shipped
config uses:

  * nested ``name { ... }`` blocks (brace on its own line or after the name;
    a block on one line is rejected, where the JAX parser misreads it)
  * ``key = value`` / ``key : value`` pairs (string/int/float/bool scalars)
  * ``${path.to.key}`` substitution, including chained references
  * ``//`` and ``#`` comments

Anything outside the subset (``include`` statements, ``+=`` appends, array
literals, multi-line values, object merging) is rejected with an error
naming the construct and the line, never silently misparsed.
"""

from __future__ import annotations

import re


class Config:
    """Flat dotted-key config with reference-compatible item access."""

    def __init__(self, values: dict[str, object]):
        self._values = dict(values)

    def __getitem__(self, key: str):
        return self._values[key]

    def get(self, key: str, default=None):
        return self._values.get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def keys(self):
        return self._values.keys()

    def __repr__(self):
        return f"Config({self._values!r})"


_SUBST = re.compile(r"\$\{([^}]+)\}")


def _coerce(raw: str):
    raw = raw.strip()
    if raw and raw[0] in "\"'" and raw[-1] == raw[0] and len(raw) >= 2:
        return raw[1:-1]
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


class HoconSubsetError(ValueError):
    """A construct outside the supported HOCON-lite subset was used."""


def _reject_unsupported(line: str, lineno: int) -> None:
    """Fail loudly on HOCON features the lite parser does not implement."""
    if line.startswith("include ") or line == "include":
        raise HoconSubsetError(
            f"line {lineno}: 'include' is full-HOCON only; install pyhocon "
            f"or inline the included file")
    # '+=' as the key/value SEPARATOR is the append operator; the same
    # two characters inside a quoted value (cmd = "make FLAGS+=-O2") are
    # plain data — only inspect the text before the first quote
    unquoted = line.split('"', 1)[0].split("'", 1)[0]
    if "+=" in unquoted:
        raise HoconSubsetError(
            f"line {lineno}: '+=' append is full-HOCON only; install "
            f"pyhocon or write the final value directly")
    # a value starting with '[' is an array literal (possibly multi-line)
    for sep in ("=", ":"):
        if sep in line:
            _, raw = line.split(sep, 1)
            if raw.strip().startswith("["):
                raise HoconSubsetError(
                    f"line {lineno}: array literals are full-HOCON only; "
                    f"install pyhocon")
            break
    # a brace other than the one that ends a block's opening line, or the
    # closing line's own, opens or closes a block on one line ('a { b = 1
    # }'), which the line-by-line parse would read as one garbled key
    braces = _SUBST.sub("", unquoted)
    if line != "}" and ("}" in braces or "{" in braces[:-1]):
        raise HoconSubsetError(
            f"line {lineno}: a block on one line is full-HOCON only; put "
            f"each key and the closing brace on lines of their own")


def _strip_comment(line: str) -> str:
    """Drop a trailing ``//`` or ``#`` comment, but not inside quotes
    (so ``url = "http://x"`` keeps its value intact)."""
    quote = ""
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = ""
        elif ch in "\"'":
            quote = ch
        elif ch == "#" or line.startswith("//", i):
            return line[:i]
    return line


def parse_hocon(text: str) -> Config:
    values: dict[str, object] = {}
    stack: list[str] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = _strip_comment(line).strip()
        if not line:
            continue
        _reject_unsupported(line, lineno)
        if line.endswith("{"):
            # HOCON allows an optional separator before the brace
            # ('name = {' / 'name : {'); without stripping it the block
            # name would keep the trailing '=' and every nested key would
            # silently misparse ('name =.child')
            name = line[:-1].strip()
            if name.endswith(("=", ":")):
                name = name[:-1].strip()
            stack.append(name)
            continue
        if line == "}":
            if not stack:
                raise ValueError(f"line {lineno}: unmatched '}}'")
            stack.pop()
            continue
        # HOCON accepts both '=' and ':' as key/value separators; pick
        # whichever comes first so 'url = "http://x"' keeps its colon.
        sep_pos = min((p for p in (line.find("="), line.find(":")) if p >= 0),
                      default=-1)
        if sep_pos >= 0:
            key, raw = line[:sep_pos], line[sep_pos + 1:]
            full_key = ".".join(stack + [key.strip()])
            values[full_key] = raw.strip()
            continue
        raise ValueError(f"line {lineno}: cannot parse {line!r}")
    if stack:
        raise ValueError(f"unclosed block {'.'.join(stack)!r}")

    # resolve ${a.b} substitutions (strings concatenate, HOCON-style),
    # iterating to handle chains
    for _ in range(10):
        changed = False
        for k, v in values.items():
            if not isinstance(v, str) or "${" not in v:
                continue

            def repl(m):
                ref = m.group(1).strip()
                if ref not in values:
                    raise HoconSubsetError(
                        f"unresolved substitution ${{{ref}}} in key {k!r}")
                return str(values[ref])

            new = _SUBST.sub(repl, v)
            if new != v:
                values[k] = new
                changed = True
        if not changed:
            break
    # anything still containing a ${...} after the passes is a cycle
    # (a=${b}, b=${a} reaches the literal fixed point "${a}") or a chain
    # deeper than the iteration cap — fail loudly rather than hand
    # literal substitution text to _coerce
    unresolved = [k for k, v in values.items()
                  if isinstance(v, str) and _SUBST.search(v)]
    if unresolved:
        raise HoconSubsetError(
            f"substitutions did not resolve (cycle or chain deeper than "
            f"10): {unresolved!r}")

    return Config({k: (_coerce(v) if isinstance(v, str) else v)
                   for k, v in values.items()})


def load_config(path: str) -> Config:
    """Parse a HOCON file; full pyhocon when available, lite subset otherwise."""
    try:
        import pyhocon  # noqa: F401  (optional)
    except ImportError:
        with open(path) as fp:
            return parse_hocon(fp.read())
    tree = pyhocon.ConfigFactory.parse_file(path)
    flat: dict[str, object] = {}

    def walk(node, prefix):
        for key, val in node.items():
            dotted = f"{prefix}.{key}" if prefix else key
            if isinstance(val, pyhocon.ConfigTree):
                walk(val, dotted)
            else:
                flat[dotted] = val

    walk(tree, "")
    return Config(flat)
