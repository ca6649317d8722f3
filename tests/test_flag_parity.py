"""Automated CLI flag parity against the reference's own cxxopts tables.

Instead of a hand-maintained list, this test PARSES the reference sources
(/root/reference/annonet_train_main.cpp:276-308 and
annonet_infer_main.cpp:309-317) and asserts that every reference option
exists in this framework's argparse parsers with the same short alias,
the same literal default (where the reference declares one), the same
flag arity (boolean vs valued vs repeatable), and nothing renamed.

Skipped when the reference checkout is not mounted (the suite must stay
self-contained); in the build environment it pins the parity claim in
PARITY.md mechanically.
"""

import os
import re

import pytest

REFERENCE = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REFERENCE), reason="reference checkout not mounted"
)

# cxxopts entry: ("short,long-name", "description"[, cxxopts::value<T>()
#                 [->default_value("literal")]])
_ENTRY = re.compile(
    r'\(\s*"(?P<names>[A-Za-z0-9,\-]+)"\s*,\s*'
    r'"(?:[^"\\]|\\.)*"'
    r"(?:\s*,\s*cxxopts::value<(?P<type>.+?)>\(\)"
    r'(?:\s*->\s*default_value\(\s*(?:"(?P<default>[^"]*)"|[^)]*)\s*\))?'
    r")?\s*\)"
)


def _reference_options(filename):
    """Yield (short, long, ctype, literal_default) from an add_options() block."""
    with open(os.path.join(REFERENCE, filename)) as f:
        source = f.read()
    start = source.index("add_options()")
    end = source.index(";", start)
    block = source[start:end]
    out = []
    for m in _ENTRY.finditer(block):
        names = m.group("names").split(",")
        short, long = (names[0], names[1]) if len(names) == 2 else (None, names[0])
        out.append((short, long, m.group("type"), m.group("default")))
    assert out, f"no cxxopts entries parsed from {filename}"
    return out


def _actions_by_option(parser):
    table = {}
    for action in parser._actions:  # introspection is fine in a test
        for opt in action.option_strings:
            table[opt] = action
    return table


def _check_parity(parser, ref_options, *, skip_default=()):
    actions = _actions_by_option(parser)
    problems = []
    for short, long, ctype, default in ref_options:
        if long == "input-directory":
            # positional in both; the -i alias is also kept
            assert "--input-directory" in actions
            continue
        opt = "--" + long
        if opt not in actions:
            problems.append(f"missing flag {opt}")
            continue
        action = actions[opt]
        if short is not None and "-" + short not in action.option_strings:
            problems.append(f"{opt}: missing short alias -{short}")
        if ctype is None:
            # reference boolean switch -> store_true defaulting to False
            if not (action.const is True and action.default is False):
                problems.append(f"{opt}: expected a store_true boolean switch")
            continue
        if "vector" in ctype:
            # repeatable flag -> argparse append action
            if getattr(action, "nargs", None) == 0 or action.__class__.__name__ not in (
                "_AppendAction",
            ):
                problems.append(f"{opt}: expected a repeatable (append) flag")
            continue
        if default is not None and long not in skip_default:
            want = float(default)
            got = action.default
            if got is None or float(got) != want:
                problems.append(f"{opt}: default {got!r} != reference {default!r}")
    assert not problems, "\n".join(problems)


def test_train_flags_match_reference_table():
    """Every flag in annonet_train_main.cpp:276-308 exists with the same
    short name, default and arity."""
    from annonet_jax.cli.train import build_parser

    _check_parity(build_parser(), _reference_options("annonet_train_main.cpp"))


def test_infer_flags_match_reference_table():
    """Every flag in annonet_infer_main.cpp:309-317 exists with the same
    short name and arity (tile defaults are hardware-conditional in the
    reference itself — 1024 CUDA / 4096 CPU — and measured per-hardware
    here: docs/DESIGN.md §22)."""
    from annonet_jax.cli.infer import build_parser

    _check_parity(build_parser(), _reference_options("annonet_infer_main.cpp"))


def test_reference_tables_fully_parsed():
    """Guard the extractor itself: the known table sizes (SURVEY.md §5 —
    train has 29 options incl. the grayscale-gated -o, infer has 7)."""
    assert len(_reference_options("annonet_train_main.cpp")) == 29
    assert len(_reference_options("annonet_infer_main.cpp")) == 7
