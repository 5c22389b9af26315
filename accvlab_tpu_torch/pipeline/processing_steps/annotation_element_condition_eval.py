"""Per-object boolean condition evaluation via the mini-parser DSL.

Port of ``accvlab_tpu/pipeline/processing_steps/annotation_element_condition_eval.py``.
The condition string (e.g. ``"is_valid = visibility > 0.4 and num_pts > 0"``)
is parsed once at construction into an AST (the port's copy of the
``mini_parser``); evaluation is element-wise over the annotation's
per-object fields. ``placement = "any"``: on the host the fields are one
sample's numpy arrays and the result follows numpy's rules; on the device
they are ``(B, N)`` tensors, and the result is a bool tensor made there
(literals compare as float32 Python scalars, as the JAX package's traced
comparisons do; nothing is read back).
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from .pipeline_step_base import PipelineStepBase
from ..dtypes import DType
from ..mini_parser import AST, And, Comparison, Literal, Not, Or, Parser, UnaryMinus, Variable
from ..sample_data_group import SampleDataGroup

Name = Union[str, int]


def _operands(a, b):
    """Beside a tensor, a float32 literal is the same value as a Python float
    (a scalar operand: nothing is copied to the device)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (float(a) if isinstance(a, np.floating) else a,
                float(b) if isinstance(b, np.floating) else b)
    return a, b


def _as_bool(value):
    if isinstance(value, torch.Tensor):
        return value.to(torch.bool)
    return np.asarray(value).astype(bool)


class AnnotationElementConditionEval(PipelineStepBase):
    """Evaluate a DSL condition per object and store the bool result field."""

    placement = "any"

    def __init__(
        self,
        annotation_field_name: Name,
        condition: str,
        remove_data_fields_used_in_condition: bool,
    ):
        super().__init__()
        self._annotation_field_name = annotation_field_name
        statement = Parser(condition).parse()
        self._condition = statement.expression
        self._result_field_name = statement.variable.name
        self._remove_used = remove_data_fields_used_in_condition

    # -- evaluation ------------------------------------------------------ #

    @classmethod
    def _eval(cls, annotation: SampleDataGroup, node: AST):
        if isinstance(node, Comparison):
            a, b = _operands(cls._eval(annotation, node.val1),
                             cls._eval(annotation, node.val2))
            op = node.comparison_type
            if op == "==":
                return a == b
            if op == "!=":
                return a != b
            if op == "<":
                return a < b
            if op == "<=":
                return a <= b
            if op == ">":
                return a > b
            if op == ">=":
                return a >= b
            raise NotImplementedError(f"Comparison {op} not supported")
        if isinstance(node, Not):
            v = cls._eval(annotation, node.condition)
            if isinstance(v, torch.Tensor):
                return torch.logical_not(v.to(torch.bool))
            return np.logical_not(np.asarray(v).astype(bool))
        if isinstance(node, UnaryMinus):
            return -cls._eval(annotation, node.value)
        if isinstance(node, (And, Or)):
            results = [_as_bool(cls._eval(annotation, c)) for c in node.conditions]
            acc = results[0]
            for r in results[1:]:
                acc = (acc & r) if isinstance(node, And) else (acc | r)
            return acc
        if isinstance(node, Variable):
            return annotation[node.name]
        if isinstance(node, Literal):
            return np.float32(float(node.value))
        raise NotImplementedError(f"Condition type not supported: {type(node)}")

    @classmethod
    def _used_fields(cls, node: AST) -> List[str]:
        if isinstance(node, Variable):
            return [node.name]
        if isinstance(node, Comparison):
            return cls._used_fields(node.val1) + cls._used_fields(node.val2)
        if isinstance(node, (And, Or)):
            res = []
            for c in node.conditions:
                res += cls._used_fields(c)
            return res
        if isinstance(node, Not):
            return cls._used_fields(node.condition)
        if isinstance(node, UnaryMinus):
            return cls._used_fields(node.value)
        return []

    # -- step interface -------------------------------------------------- #

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        for ap in data.find_all_occurrences(self._annotation_field_name):
            annotations = data.get_item_in_path(ap)
            result = _as_bool(self._eval(annotations, self._condition))
            annotations.add_data_field(self._result_field_name, DType.BOOL)
            annotations[self._result_field_name] = result
        if self._remove_used:
            self._remove_condition_fields(data)
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        annotation_paths = data_empty.find_all_occurrences(self._annotation_field_name)
        if len(annotation_paths) == 0:
            raise ValueError(
                f"No occurrences of annotations found with name "
                f"'{self._annotation_field_name}'."
            )
        used = sorted(set(self._used_fields(self._condition)))
        for ap in annotation_paths:
            annotation = data_empty.get_item_in_path(ap)
            annotation.check_has_children(used)
            annotation.add_data_field(self._result_field_name, DType.BOOL)
        if self._remove_used:
            self._remove_condition_fields(data_empty)
        return data_empty

    def _remove_condition_fields(self, data: SampleDataGroup):
        used = sorted(set(self._used_fields(self._condition)))
        for ap in data.find_all_occurrences(self._annotation_field_name):
            annotation = data.get_item_in_path(ap)
            for field in used:
                annotation.remove_field(field)
