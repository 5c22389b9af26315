"""Pratt parser for the condition DSL (parity: reference
``mini_parser/parser.py:20-178``; same grammar and operator priorities)."""

from __future__ import annotations

from . import ast_nodes as ast
from .lexer import Lexer, Token, TokenType


class Parser:
    """Parses ``<res_var> = <expression>``.

    Expression operators (by binding priority, low to high): ``or``, ``and``,
    comparisons (``== != < <= > >=``), ``not`` / unary ``-``, parentheses.
    Python-like syntax; only numeric literals; no chained comparisons.
    """

    _priority = {
        TokenType.LOGICAL_OR: 1,
        TokenType.LOGICAL_AND: 2,
        TokenType.COMPARISON: 3,
    }
    _PREFIX_PRIORITY = 4

    def __init__(self, input_str: str):
        lexer = Lexer(input_str)
        self._tokens = []
        while True:
            token = lexer.next_token()
            self._tokens.append(token)
            if token.type == TokenType.EOL:
                break
        self._idx = 0

    def _cur(self) -> Token:
        return self._tokens[self._idx]

    def _advance(self):
        self._idx += 1

    def _expect(self, token_type: TokenType, message: str) -> Token:
        tok = self._cur()
        if tok.type != token_type:
            raise ValueError(message)
        self._advance()
        return tok

    def parse(self) -> ast.Assignment:
        var = self._expect(
            TokenType.VARIABLE,
            "The condition must start with `<res_var_name> = ...`",
        )
        self._expect(
            TokenType.ASSIGNMENT,
            "The condition must start with `<res_var_name> = ...`",
        )
        expression = self._parse_expression(0)
        if self._cur().type != TokenType.EOL:
            raise ValueError(f"Unexpected trailing token: {self._cur()!r}")
        return ast.Assignment(ast.Variable(var.value), expression)

    def _parse_expression(self, min_priority: int) -> ast.AST:
        left = self._parse_prefix()
        while True:
            tok = self._cur()
            prio = self._priority.get(tok.type, 0)
            if prio <= min_priority:
                return left
            self._advance()
            if tok.type == TokenType.COMPARISON:
                right = self._parse_expression(prio)
                left = ast.Comparison(left, tok.value, right)
            elif tok.type == TokenType.LOGICAL_AND:
                right = self._parse_expression(prio)
                if isinstance(left, ast.And):
                    left = ast.And(*left.conditions, right)
                else:
                    left = ast.And(left, right)
            elif tok.type == TokenType.LOGICAL_OR:
                right = self._parse_expression(prio)
                if isinstance(left, ast.Or):
                    left = ast.Or(*left.conditions, right)
                else:
                    left = ast.Or(left, right)

    def _parse_prefix(self) -> ast.AST:
        tok = self._cur()
        if tok.type == TokenType.VARIABLE:
            self._advance()
            return ast.Variable(tok.value)
        if tok.type == TokenType.LITERAL:
            self._advance()
            return ast.Literal(tok.value)
        if tok.type == TokenType.MINUS:
            self._advance()
            return ast.UnaryMinus(self._parse_expression(self._PREFIX_PRIORITY))
        if tok.type == TokenType.LOGICAL_NOT:
            self._advance()
            return ast.Not(self._parse_expression(self._PREFIX_PRIORITY))
        if tok.type == TokenType.PARENTHESIS_OPEN:
            self._advance()
            inner = self._parse_expression(0)
            self._expect(TokenType.PARENTHESIS_CLOSE, "Missing closing parenthesis")
            return inner
        raise ValueError(f"Unexpected token: {tok!r}")
