"""Write `csrc/unicode_classes.inc`: the code-point classes that the C++
CLIP pretokenizer (`csrc/comat_host.cpp`) needs to split text as
`text.tokenizer._CLIP_PAT` does under Python's `re`.

    python -m comat_tpu_torch.tools.gen_unicode_classes

The pattern's classes, for a str pattern under re.IGNORECASE: a letter
run is `[^\\W\\d_]` (a word character, `str.isalnum()`, that is neither a
decimal digit, `\\d`, nor "_"); whitespace (`\\s`), decimal digits and "_"
start no token; everything else (but "'" and the ASCII digits, which the
C++ matches itself) runs as punctuation `[^\\s\\w']`. The table holds the
letter and the skipped ranges; a code point in neither is punctuation.
Also written: the code points that match each ASCII letter under
re.IGNORECASE (the contractions and special tokens match through them).
The table follows this interpreter's Unicode version
(`unicodedata.unidata_version`), which tests/test_torch_native_host.py
checks against the committed file.
"""

from __future__ import annotations

import os
import re
import string
import unicodedata
from typing import List, Tuple

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                   "unicode_classes.inc")
LETTER, SKIP = 1, 2

_LETTER = re.compile(r"[^\W\d_]", re.IGNORECASE | re.UNICODE)
_SKIP = re.compile(r"[\s\d_]", re.IGNORECASE | re.UNICODE)


def _code_points():
    return (cp for cp in range(0x110000) if not 0xD800 <= cp <= 0xDFFF)


def class_ranges() -> List[Tuple[int, int, int]]:
    """[(first, last, class)] in code-point order, adjacent ranges of one
    class merged."""
    out: List[Tuple[int, int, int]] = []
    for cp in _code_points():
        ch = chr(cp)
        cls = LETTER if _LETTER.match(ch) else SKIP if _SKIP.match(ch) else 0
        if not cls:
            continue
        if out and out[-1][2] == cls and out[-1][1] == cp - 1:
            out[-1] = (out[-1][0], cp, cls)
        elif out and out[-1][2] == cls and all(0xD800 <= c <= 0xDFFF
                                               for c in range(out[-1][1] + 1, cp)):
            out[-1] = (out[-1][0], cp, cls)
        else:
            out.append((cp, cp, cls))
    return out


def case_variants() -> List[Tuple[str, List[int]]]:
    """For each ASCII lowercase letter, the other code points it matches
    under re.IGNORECASE."""
    return [(c, [cp for cp in _code_points() if chr(cp) != c
                 and re.fullmatch(c, chr(cp), re.IGNORECASE)])
            for c in string.ascii_lowercase]


def render() -> str:
    lines = [
        "// Generated by `python -m comat_tpu_torch.tools.gen_unicode_classes`",
        f"// from Unicode {unicodedata.unidata_version}: do not edit.",
        "// {first, last, class}: 1 letter ([^\\W\\d_]), 2 skipped ([\\s\\d_]).",
        "static const UnicodeRange kClassRanges[] = {",
    ]
    ranges = class_ranges()
    for i in range(0, len(ranges), 4):
        lines.append("    " + " ".join(f"{{0x{a:X}, 0x{b:X}, {c}}},"
                                        for a, b, c in ranges[i:i + 4]))
    lines.append("};")
    lines.append("// {ASCII letter, code point} pairs: the letter's other matches under "
                 "re.IGNORECASE.")
    lines.append("static const CaseVariant kCaseVariants[] = {")
    for c, cps in case_variants():
        for cp in cps:
            lines.append(f"    {{'{c}', 0x{cp:X}}},")
    lines.append("};")
    lines.append(f'static const char kUnicodeVersion[] = "{unicodedata.unidata_version}";')
    return "\n".join(lines) + "\n"


def main() -> None:
    with open(OUT, "w") as f:
        f.write(render())
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
