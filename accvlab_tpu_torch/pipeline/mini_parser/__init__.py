"""Mini-parser for the annotation-condition DSL.

The port's own copy of ``accvlab_tpu/pipeline/mini_parser`` (numpy-free
Python, identical apart from this docstring). Grammar: ``<res_var> =
<expression>`` with ``or``/``and``/``not``, comparisons, unary minus,
parentheses and numeric literals. Used by
:class:`~accvlab_tpu_torch.pipeline.processing_steps.AnnotationElementConditionEval`.
"""

from .ast_nodes import AST, And, Assignment, Comparison, Literal, Not, Or, UnaryMinus, Variable
from .lexer import Lexer, Token, TokenType
from .parser import Parser

__all__ = [
    "AST",
    "And",
    "Assignment",
    "Comparison",
    "Lexer",
    "Literal",
    "Not",
    "Or",
    "Parser",
    "Token",
    "TokenType",
    "UnaryMinus",
    "Variable",
]
