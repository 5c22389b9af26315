"""Tokenizer for the condition DSL (parity: reference ``mini_parser/lexer.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class TokenType(Enum):
    LITERAL = "literal"
    VARIABLE = "variable"
    ASSIGNMENT = "assignment"
    COMPARISON = "comparison"
    LOGICAL_OR = "logical_or"
    LOGICAL_AND = "logical_and"
    LOGICAL_NOT = "logical_not"
    MINUS = "minus"
    PARENTHESIS_OPEN = "parenthesis_open"
    PARENTHESIS_CLOSE = "parenthesis_close"
    EOL = "end_of_line"


@dataclass(frozen=True)
class Token:
    type: TokenType
    value: str

    def __repr__(self):
        return f"Token({self.type.value}, {self.value!r})"


_KEYWORDS = {
    "or": TokenType.LOGICAL_OR,
    "and": TokenType.LOGICAL_AND,
    "not": TokenType.LOGICAL_NOT,
}

_COMPARISON_OPS = {"==", "!=", "<", "<=", ">", ">="}


class Lexer:
    """Streaming tokenizer; ``next_token()`` yields tokens until EOL."""

    def __init__(self, input: str):
        self._s = input
        self._pos = 0

    def _peek(self) -> str:
        return self._s[self._pos] if self._pos < len(self._s) else ""

    def next_token(self) -> Token:
        while self._peek().isspace():
            self._pos += 1
        ch = self._peek()
        if not ch:
            return Token(TokenType.EOL, "")
        if ch.isalpha() or ch == "_":
            start = self._pos
            while self._peek().isalnum() or self._peek() == "_":
                self._pos += 1
            word = self._s[start : self._pos]
            if word in _KEYWORDS:
                return Token(_KEYWORDS[word], word)
            return Token(TokenType.VARIABLE, word)
        if ch.isdigit() or (ch == "." and self._pos + 1 < len(self._s)):
            start = self._pos
            while self._peek().isdigit() or self._peek() == ".":
                self._pos += 1
            num = self._s[start : self._pos]
            if num.count(".") > 1:
                raise ValueError(f"Invalid numeric literal: {num}")
            return Token(TokenType.LITERAL, num)
        if ch == "-":
            self._pos += 1
            return Token(TokenType.MINUS, "-")
        if ch == "(":
            self._pos += 1
            return Token(TokenType.PARENTHESIS_OPEN, "(")
        if ch == ")":
            self._pos += 1
            return Token(TokenType.PARENTHESIS_CLOSE, ")")
        if ch in "=!<>":
            two = self._s[self._pos : self._pos + 2]
            if two in _COMPARISON_OPS:
                self._pos += 2
                return Token(TokenType.COMPARISON, two)
            if ch == "=":
                self._pos += 1
                return Token(TokenType.ASSIGNMENT, "=")
            if ch in "<>":
                self._pos += 1
                return Token(TokenType.COMPARISON, ch)
            raise ValueError(f"Unexpected character sequence at {self._pos}: {two!r}")
        raise ValueError(f"Unexpected character at position {self._pos}: {ch!r}")
