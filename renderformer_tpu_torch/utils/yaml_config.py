"""A reader of the YAML subset that the repo's configs use, in plain Python.

``train.load_config`` reads ``configs/*.yml`` with it, so that fine-tuning
needs no PyYAML.  The subset: block mappings nested by indentation; ``#``
comments; plain, single-quoted and double-quoted scalars on one line; and
sequences of scalars, in flow (``[a, b]``) or block (``- a``) form, a block
sequence under a key indented or at the key's own column.  A single leading
``---`` is allowed.

Plain scalars resolve as ``yaml.safe_load`` resolves them (PyYAML's YAML 1.1
resolver): ``true/false/yes/no/on/off`` in their three cases are booleans;
``null``, ``Null``, ``NULL``, ``~`` and the empty value are None; integers
take ``_`` between digits, ``0b`` binary, ``0x`` hex, a leading ``0`` octal
and ``:`` base 60 (``0o17`` stays a string, as there); a float needs a dot
and its exponent a sign, so ``5e-6`` and ``1.0e4`` stay strings while
``1.0e+4`` is a float; ``.inf`` and ``.nan`` are floats.  Keys resolve the
same way; a repeated key keeps its last value.

Anchors, aliases, tags, block scalars, flow mappings, complex keys, merge
keys, timestamps, multi-line scalars, directives and more than one document
raise a ``ValueError`` that names the line.  So the reader accepts less than
``yaml.safe_load`` does: a config that uses one of these is refused, never
read differently, and is rewritten in the subset to train.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

_BOOL = {'yes': True, 'no': False, 'true': True, 'false': False, 'on': True, 'off': False}
_BOOL_RE = re.compile(r'^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE'
                      r'|on|On|ON|off|Off|OFF)$')
_FLOAT_RE = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                           |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                           |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                           |[-+]?\.(?:inf|Inf|INF)
                           |\.(?:nan|NaN|NAN))$''', re.X)
_INT_RE = re.compile(r'''^(?:[-+]?0b[0-1_]+
                         |[-+]?0[0-7_]+
                         |[-+]?(?:0|[1-9][0-9_]*)
                         |[-+]?0x[0-9a-fA-F_]+
                         |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_NULL_RE = re.compile(r'^(?:~|null|Null|NULL|)$')
_TIMESTAMP_RE = re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                               |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                               (?:[Tt]|[ \t]+)[0-9][0-9]?
                               :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                               (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''', re.X)
# each resolver and the first characters it is tried on, in PyYAML's order
_RESOLVERS = (('bool', _BOOL_RE, 'yYnNtTfFoO'), ('float', _FLOAT_RE, '-+0123456789.'),
              ('int', _INT_RE, '-+0123456789'), ('merge', re.compile(r'^<<$'), '<'),
              ('null', _NULL_RE, '~nN'), ('timestamp', _TIMESTAMP_RE, '0123456789'),
              ('value', re.compile(r'^=$'), '='))
_ESCAPES = {'0': '\0', 'a': '\x07', 'b': '\x08', 't': '\t', '\t': '\t', 'n': '\n', 'v': '\x0b',
            'f': '\x0c', 'r': '\r', 'e': '\x1b', ' ': ' ', '"': '"', '/': '/', '\\': '\\',
            'N': '\x85', '_': '\xa0', 'L': '\u2028', 'P': '\u2029'}
_HEX_ESCAPES = {'x': 2, 'u': 4, 'U': 8}
_UNSUPPORTED = {'&': 'an anchor', '*': 'an alias', '!': 'a tag', '|': 'a block scalar',
                '>': 'a block scalar', '{': 'a flow mapping', '%': 'a directive',
                '@': 'a reserved indicator', '`': 'a reserved indicator'}


class _Line:
    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text


def _error(number: int, what: str) -> ValueError:
    return ValueError(f'line {number}: {what} (outside the YAML subset this reader takes)')


def _resolve(text: str, number: int):
    """A plain scalar's value, as ``yaml.safe_load`` resolves it."""
    kind = None
    for name, regex, first in _RESOLVERS:
        if (not text and name == 'null') or (text and text[0] in first and regex.match(text)):
            kind = name
            break
    if kind is None:
        return text
    if kind == 'bool':
        return _BOOL[text.lower()]
    if kind == 'null':
        return None
    if kind in ('merge', 'value', 'timestamp'):
        raise _error(number, f'{text!r} resolves to a {kind}')
    value = text.replace('_', '')
    if kind == 'float':
        value = value.lower()
    sign = -1 if value[0] == '-' else 1
    if value[0] in '+-':
        value = value[1:]
    if kind == 'float':
        if value == '.inf':
            return sign * float('inf')
        if value == '.nan':
            return float('nan')
        if ':' in value:
            parts = reversed(value.split(':'))
            return sign * sum(float(p) * 60 ** i for i, p in enumerate(parts))
        return sign * float(value)
    if value == '0':
        return 0
    if value.startswith('0b'):
        return sign * int(value[2:], 2)
    if value.startswith('0x'):
        return sign * int(value[2:], 16)
    if value[0] == '0':
        return sign * int(value, 8)
    if ':' in value:
        return sign * sum(int(p) * 60 ** i for i, p in enumerate(reversed(value.split(':'))))
    return sign * int(value)


def _quoted(text: str, number: int) -> Tuple[str, str]:
    """(value, the rest of the line) of the quoted scalar ``text`` opens."""
    quote, out, i = text[0], [], 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return ''.join(out), text[i + 1:]
        if quote == '"' and c == '"':
            return ''.join(out), text[i + 1:]
        if quote == '"' and c == '\\':
            e = text[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = text[i + 2:i + 2 + n]
                if len(digits) != n or not all(d in '0123456789abcdefABCDEF' for d in digits):
                    raise _error(number, f'a bad escape \\{e}{digits}')
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            raise _error(number, f'the escape \\{e}' if e else 'a quoted scalar over lines')
        out.append(c)
        i += 1
    raise _error(number, 'a quoted scalar that does not close on its line')


def _rest_is_blank(rest: str, number: int, what: str) -> None:
    stripped = rest.lstrip(' \t')
    if stripped and not (stripped[0] == '#' and len(stripped) < len(rest)):
        if stripped[0] == '#':
            raise _error(number, f'a comment with no space before it after {what}')
        raise _error(number, f'{stripped!r} after {what}')


def _check_plain_start(text: str, number: int) -> None:
    c = text[0]
    if c in _UNSUPPORTED:
        raise _error(number, _UNSUPPORTED[c])
    if c in '?:-' and (len(text) == 1 or text[1] in ' \t'):
        raise _error(number, {'?': 'a complex key', ':': 'an empty key',
                              '-': 'a sequence in this place'}[c])
    if c in ',]}':
        raise _error(number, f'a plain scalar that starts with {c!r}')


def _plain_end(text: str) -> int:
    """Where a plain scalar of block context ends: at a comment."""
    m = re.search(r'[ \t]#', text)
    return m.start() if m else len(text)


def _scalar(text: str, number: int):
    """The value of a whole value text: a quoted or plain scalar or a flow
    sequence of scalars, a comment allowed after it."""
    text = text.lstrip(' \t')
    if not text or text[0] == '#':
        return None
    if text[0] in '\'"':
        value, rest = _quoted(text, number)
        _rest_is_blank(rest, number, 'a quoted scalar')
        return value
    if text[0] == '[':
        return _flow_sequence(text, number)
    _check_plain_start(text, number)
    plain = text[:_plain_end(text)].rstrip(' \t')
    if re.search(r':([ \t]|$)', plain):
        raise _error(number, 'a mapping in a value (": " inside a plain scalar)')
    return _resolve(plain, number)


def _flow_sequence(text: str, number: int) -> list:
    items, i = [], 1
    while True:
        while i < len(text) and text[i] in ' \t':
            i += 1
        if i >= len(text):
            raise _error(number, 'a flow sequence that does not close on its line')
        c = text[i]
        if c == ']':   # right after '[' or after a trailing comma
            _rest_is_blank(text[i + 1:], number, 'a flow sequence')
            return items
        if c in '\'"':
            value, rest = _quoted(text[i:], number)
            i = len(text) - len(rest)
        elif c in '[{':
            raise _error(number, 'a nested flow collection')
        else:
            if c == ',':
                raise _error(number, 'an empty entry in a flow sequence')
            _check_plain_start(text[i:], number)
            m = re.compile(r',|\]|[ \t]#|:[ \t,\]]|[\[{}]').search(text, i)
            end = m.start() if m else len(text)
            if m and m.group(0)[0] in '[{}':
                raise _error(number, f'{m.group(0)!r} inside a flow sequence')
            if m and m.group(0).startswith(':'):
                raise _error(number, 'a mapping inside a flow sequence')
            if m and m.group(0).lstrip(' \t').startswith('#'):
                raise _error(number, 'a flow sequence that does not close on its line')
            value = _resolve(text[i:end].rstrip(' \t'), number)
            i = end
        items.append(value)
        while i < len(text) and text[i] in ' \t':
            i += 1
        if i < len(text) and text[i] == ',':
            i += 1
            continue
        if i < len(text) and text[i] == ']':
            _rest_is_blank(text[i + 1:], number, 'a flow sequence')
            return items
        raise _error(number, 'a flow sequence that does not close on its line')


def _key(text: str, number: int) -> Optional[Tuple[object, str]]:
    """(key, value text) where the line is a mapping entry, else None."""
    if text[0] in '\'"':
        key, rest = _quoted(text, number)
        rest2 = rest.lstrip(' \t')
        if rest2[:1] == ':' and (len(rest2) == 1 or rest2[1] in ' \t'):
            return key, rest2[1:]
        return None
    m = re.search(r':([ \t]|$)', text[:_plain_end(text)])
    if not m:
        return None
    raw = text[:m.start()].rstrip(' \t')
    if not raw:
        raise _error(number, 'an empty key')
    _check_plain_start(raw, number)
    return _resolve(raw, number), text[m.end():]


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines, self.i = lines, 0

    def peek(self) -> Optional[_Line]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    @staticmethod
    def is_item(line: _Line) -> bool:
        return line.text == '-' or line.text.startswith(('- ', '-\t'))

    def block(self, indent: int):
        line = self.peek()
        if self.is_item(line):
            return self.sequence(indent)
        return self.mapping(indent)

    def sequence(self, indent: int) -> list:
        items = []
        while (line := self.peek()) is not None and line.indent == indent and self.is_item(line):
            self.i += 1
            text = line.text[1:].lstrip(' \t')
            nxt = self.peek()
            if not text or text[0] == '#':
                if nxt is not None and nxt.indent > indent:
                    raise _error(nxt.number, 'a collection inside a block sequence')
                items.append(None)
                continue
            if text[0] == '[' or text[0] == '-' and (len(text) == 1 or text[1] in ' \t'):
                raise _error(line.number, 'a sequence inside a block sequence')
            if _key(text, line.number) is not None:
                raise _error(line.number, 'a mapping inside a block sequence')
            items.append(_scalar(text, line.number))
            if nxt is not None and nxt.indent > indent:
                raise _error(nxt.number, 'a scalar over lines')
        return items

    def mapping(self, indent: int) -> dict:
        out = {}
        while (line := self.peek()) is not None and line.indent >= indent:
            if line.indent > indent:
                raise _error(line.number, 'an indentation that matches no enclosing block')
            if self.is_item(line):
                raise _error(line.number, 'a sequence item where a mapping key belongs')
            entry = _key(line.text, line.number)
            if entry is None:
                raise _error(line.number, f'{line.text!r} where a "key: value" belongs')
            key, rest = entry
            self.i += 1
            nxt = self.peek()
            value_text = rest.lstrip(' \t')
            if value_text and value_text[0] != '#':
                out[key] = _scalar(value_text, line.number)
                if nxt is not None and nxt.indent > indent:
                    raise _error(nxt.number, 'a scalar over lines')
            elif nxt is not None and nxt.indent > indent:
                out[key] = self.block(nxt.indent)
            elif nxt is not None and nxt.indent == indent and self.is_item(nxt):
                out[key] = self.sequence(indent)
            else:
                out[key] = None
        return out


def _lines(text: str) -> List[_Line]:
    out, started = [], False
    for number, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(' ')
        if not body.strip(' \t') or body.lstrip(' \t').startswith('#'):
            continue
        if body[0] == '\t':
            raise _error(number, 'a tab in indentation')
        indent = len(raw) - len(body)
        stripped = body.rstrip(' \t')
        if indent == 0 and (stripped == '---' or stripped.startswith(('--- ', '---\t'))):
            if started or stripped != '---':
                raise _error(number, 'a second document or content after "---"')
            started = True
            continue
        if indent == 0 and (stripped == '...' or stripped.startswith('... ')):
            raise _error(number, 'a document end marker')
        if body[0] == '%':
            raise _error(number, 'a directive')
        started = True
        out.append(_Line(number, indent, stripped))
    return out


def load(stream):
    """The value of the YAML document ``stream`` (a str or a text file), as
    ``yaml.safe_load`` gives it for the subset; None for an empty one."""
    text = stream if isinstance(stream, str) else stream.read()
    if text.startswith('\ufeff'):
        text = text[1:]
    lines = _lines(text)
    if not lines:
        return None
    parser = _Parser(lines)
    first = lines[0]
    if len(lines) == 1 and not parser.is_item(first) and _key(first.text, first.number) is None:
        return _scalar(first.text, first.number)
    value = parser.block(first.indent)
    line = parser.peek()
    if line is not None:
        raise _error(line.number, 'an indentation that matches no enclosing block')
    return value


def load_file(path: str):
    """:func:`load` of the file at ``path``."""
    with open(path, encoding='utf-8') as f:
        return load(f.read())
