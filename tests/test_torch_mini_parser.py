"""The port's copy of the condition DSL's mini-parser against the JAX
package's: the same token streams, the same ASTs (compared node by node,
exactly) on the cases of tests/test_mini_parser.py and on random
expressions, and a ValueError on the same malformed inputs."""

import os

import numpy as np
import pytest

import accvlab_tpu.pipeline.mini_parser as jmp
import accvlab_tpu_torch.pipeline.mini_parser as tmp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [
    "res = a >= 10.5 and not (b == -2)",
    "_b1 = x_2 < 3",
    "res = a < 10",
    "r = -_b1 < 10.5",
    "r = a < 1 or b < 2 and c < 3",
    "r = (a < 1 or b < 2) and c < 3",
    "r = a < 1 and b < 2 and c < 3",
    "res_5_var = (-_b1 < 10.5 or (-c > -20 and d == 10)) and another_var > 30",
    "r = not a",
    "keep = (visibility > 0.4 or depths < 3) and not (depths == 7)",
    "is_valid = visibility > 0.4 and depths < 6",
    "v = x != .5",
]
MALFORMED = ["a = 1.2.3", "a < 10", "= a < 10", "r = (a < 1", "r = a < 1 )", "r = a ? 1",
             "r = a < 1 b", "r = ", "r = a !"]


def _lex(mod, text):
    lexer = mod.Lexer(text)
    out = []
    while True:
        t = lexer.next_token()
        out.append((t.type.value, t.value))
        if t.type == mod.TokenType.EOL:
            return out


def _tree(node):
    """A node as nested tuples of its class name and fields."""
    name = type(node).__name__
    if name == "Assignment":
        return (name, _tree(node.variable), _tree(node.expression))
    if name == "Comparison":
        return (name, _tree(node.val1), node.comparison_type, _tree(node.val2))
    if name in ("And", "Or"):
        return (name,) + tuple(_tree(c) for c in node.conditions)
    if name == "Not":
        return (name, _tree(node.condition))
    if name == "UnaryMinus":
        return (name, _tree(node.value))
    if name == "Variable":
        return (name, node.name)
    if name == "Literal":
        return (name, node.value)
    raise AssertionError(name)


@pytest.mark.parametrize("text", CASES)
def test_same_tokens_and_ast_as_jax(text):
    assert _lex(tmp, text) == _lex(jmp, text)
    got, want = tmp.Parser(text).parse(), jmp.Parser(text).parse()
    assert _tree(got) == _tree(want)
    assert repr(got) == repr(want)


@pytest.mark.parametrize("text", MALFORMED)
def test_malformed_raises_as_in_jax(text):
    with pytest.raises(ValueError) as want:
        jmp.Parser(text).parse()
    with pytest.raises(ValueError) as got:
        tmp.Parser(text).parse()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(8))
def test_random_expressions_same_ast_as_jax(seed):
    rng = np.random.default_rng(seed)
    ops = ["==", "!=", "<", "<=", ">", ">="]

    def gen(depth):
        roll = rng.random()
        if depth >= 3 or roll < 0.4:
            neg = "-" if rng.random() < 0.3 else ""
            return f"({neg}f{rng.integers(0, 4)} {ops[rng.integers(0, 6)]} {rng.integers(0, 20)})"
        if roll < 0.6:
            return f"(not {gen(depth + 1)})"
        joiner = " and " if roll < 0.8 else " or "
        return "(" + joiner.join(gen(depth + 1) for _ in range(int(rng.integers(2, 4)))) + ")"

    text = "res = " + gen(0)
    assert _tree(tmp.Parser(text).parse()) == _tree(jmp.Parser(text).parse())


@pytest.mark.parametrize("name", ["ast_nodes.py", "lexer.py", "parser.py"])
def test_copy_matches_jax_module(name):
    """The port's copy is the JAX package's module (it has only relative
    imports), byte for byte."""
    with open(os.path.join(REPO, "accvlab_tpu_torch", "pipeline", "mini_parser", name)) as a, \
            open(os.path.join(REPO, "accvlab_tpu", "pipeline", "mini_parser", name)) as b:
        assert a.read() == b.read()
