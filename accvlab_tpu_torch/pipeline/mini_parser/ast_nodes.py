"""AST nodes for the condition DSL (parity: reference ``mini_parser/ast.py``)."""

from __future__ import annotations


class AST:
    """Base class for AST nodes."""


class Assignment(AST):
    """``variable = expression`` — the top-level statement."""

    def __init__(self, variable: "Variable", expression: AST):
        self.variable = variable
        self.expression = expression

    def __repr__(self):
        return f"{self.variable!r} = {self.expression!r}"


class Literal(AST):
    """Numeric literal (kept as its source string)."""

    def __init__(self, value: str):
        self.value = value

    def __repr__(self):
        return self.value


class Variable(AST):
    """Named reference to an annotation data field."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return self.name


class Comparison(AST):
    """``val1 <op> val2`` with op in ==, !=, <, <=, >, >=."""

    def __init__(self, val1: AST, comparison_type: str, val2: AST):
        self.val1 = val1
        self.comparison_type = comparison_type
        self.val2 = val2

    def __repr__(self):
        return f"({self.val1!r} {self.comparison_type} {self.val2!r})"


class Or(AST):
    def __init__(self, *conditions: AST):
        self.conditions = conditions

    def __repr__(self):
        return "(" + " or ".join(map(repr, self.conditions)) + ")"


class And(AST):
    def __init__(self, *conditions: AST):
        self.conditions = conditions

    def __repr__(self):
        return "(" + " and ".join(map(repr, self.conditions)) + ")"


class Not(AST):
    def __init__(self, condition: AST):
        self.condition = condition

    def __repr__(self):
        return f"(not {self.condition!r})"


class UnaryMinus(AST):
    def __init__(self, value: AST):
        self.value = value

    def __repr__(self):
        return f"(-{self.value!r})"
