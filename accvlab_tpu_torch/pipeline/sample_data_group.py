"""SampleDataGroup: tree-structured, type-enforced data container / blueprint.

PyTorch port of ``accvlab_tpu/pipeline/sample_data_group.py``: identical
except that "inside the pipeline" values are torch tensors (device steps
take batched tensors), whose dtype is checked instead of converted.

Originally a re-design of the reference class at
``dali_pipeline_framework/accvlab/dali_pipeline_framework/pipeline/sample_data_group.py:35-1662``.
Same capability surface (blueprint vs container modes, string<->uint8
passthrough, value mappings, flatten/unflatten, format ops, path access);
types are :class:`DType` backed by numpy dtypes instead of DALI types.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from .dtypes import DType, numpy_dtype_for, numpy_dtype_for_torch

Name = Union[str, int]
Path = Union[str, int, Tuple[Name, ...], List[Name]]


def _is_traced(value) -> bool:
    """True for in-pipeline tensors (the equivalent of the reference's DALI
    DataNode check and of the JAX package's traced values)."""
    return isinstance(value, torch.Tensor)


class SampleDataGroup:
    """Structured container for sample data; also usable as a format blueprint.

    Data is a tree of **data fields** (leaves holding values) and **data group
    fields** (child :class:`SampleDataGroup` nodes). Access works like nested
    dicts: ``data["camera"]["annotations"]["bounding_boxes"]``.

    Capabilities (parity with the reference class):

    * enforce a predefined format — format changes are always explicit
    * automatic type conversion on assignment (host side), disable via
      :meth:`set_do_convert`
    * optional string->numeric value mappings per field
    * type *checks* on assignment for traced (in-pipeline) values, disable via
      :meth:`set_do_check_type`
    * string fields stored as uint8 byte tensors, converted on access
    * flatten/unflatten (:meth:`get_data` / :meth:`set_data`), stable
      depth-first order with dotted flat names
    * format comparison (:meth:`type_matches`), search/removal/type-change
      utilities for implementing pipeline steps
    """

    def __init__(self):
        self._mappings: Dict[Name, dict] = {}
        self._value_order: Tuple[Name, ...] = tuple()
        self._types_order: Tuple[Any, ...] = tuple()
        self._values: Dict[Name, Any] = {}
        self._types: Dict[Name, Any] = {}
        self._do_apply_mapping = True
        self._do_convert = True
        self._do_check_type = True

    # ------------------------------------------------------------------ #
    # Array constructors                                                 #
    # ------------------------------------------------------------------ #

    @staticmethod
    def create_data_field_array(
        type: DType, num_fields: int, mapping: Optional[dict] = None
    ) -> "SampleDataGroup":
        """Group with data fields named ``0..num_fields-1`` (an array).
        Parity: ``sample_data_group.py:183``."""
        res = SampleDataGroup()
        for i in range(num_fields):
            res.add_data_field(i, type, mapping)
        return res

    @staticmethod
    def create_data_group_field_array(
        sample_data_group: "SampleDataGroup", num_fields: int
    ) -> "SampleDataGroup":
        """Group with ``num_fields`` blueprint copies of ``sample_data_group``
        as elements. Parity: ``sample_data_group.py:213``."""
        res = SampleDataGroup()
        for i in range(num_fields):
            res.add_data_group_field(i, sample_data_group)
        return res

    # ------------------------------------------------------------------ #
    # Behavior switches                                                  #
    # ------------------------------------------------------------------ #

    def set_apply_mapping(self, apply: bool):
        """Toggle string->numeric mapping application on assignment."""
        self._do_apply_mapping = apply
        for name in self._value_order:
            if self._types[name] == SampleDataGroup and self._values[name] is not None:
                self._values[name].set_apply_mapping(apply)

    def set_do_convert(self, convert: bool):
        """Toggle automatic dtype conversion on assignment (host side)."""
        self._do_convert = convert
        for name in self._value_order:
            if self._types[name] == SampleDataGroup and self._values[name] is not None:
                self._values[name].set_do_convert(convert)

    def set_do_check_type(self, check_type: bool):
        """Toggle dtype checking on assignment of traced values."""
        self._do_check_type = check_type
        for name in self._value_order:
            if self._types[name] == SampleDataGroup and self._values[name] is not None:
                self._values[name].set_do_check_type(check_type)

    # ------------------------------------------------------------------ #
    # Copies                                                             #
    # ------------------------------------------------------------------ #

    def get_empty_like_self(self) -> "SampleDataGroup":
        """Blueprint copy: same format, no values. Parity: ``:300``."""
        res = SampleDataGroup()
        for name, t in zip(self._value_order, self._types_order):
            if t == SampleDataGroup:
                res.add_data_group_field(name, self._values[name])
            else:
                res.add_data_field(name, t, self._mappings.get(name))
        res._do_apply_mapping = self._do_apply_mapping
        res._do_convert = self._do_convert
        res._do_check_type = self._do_check_type
        return res

    def get_copy(self) -> "SampleDataGroup":
        """Copy including values (values are shared, not deep-copied;
        arrays are immutable in this framework). Parity: ``:324``."""
        res = self.get_empty_like_self()
        for name, t in zip(self._value_order, self._types_order):
            if t == SampleDataGroup:
                if self._values[name] is not None:
                    res._values[name] = self._values[name].get_copy()
            else:
                res._values[name] = self._values[name]
        return res

    # ------------------------------------------------------------------ #
    # Format comparison                                                  #
    # ------------------------------------------------------------------ #

    def type_matches(self, other: "SampleDataGroup") -> bool:
        """Whether ``other`` has the same field names, order, and types
        (recursively). Parity: ``:354``."""
        if not isinstance(other, SampleDataGroup):
            return False
        if self._value_order != other._value_order:
            return False
        for name, t in zip(self._value_order, self._types_order):
            ot = other._types[name]
            if t == SampleDataGroup:
                if ot != SampleDataGroup:
                    return False
                mine, theirs = self._values[name], other._values[name]
                if mine is not None and theirs is not None and not mine.type_matches(theirs):
                    return False
            elif t != ot:
                return False
        return True

    def get_flat_index_first_discrepancy_to_other(self, other: "SampleDataGroup") -> int:
        """Flat index of the first format discrepancy, or -1 if formats match.
        Parity: ``:1218``."""
        mine = list(zip(self.field_names_flat, self.field_types_flat))
        theirs = list(zip(other.field_names_flat, other.field_types_flat))
        for i in range(min(len(mine), len(theirs))):
            if mine[i] != theirs[i]:
                return i
        if len(mine) != len(theirs):
            return min(len(mine), len(theirs))
        return -1

    # ------------------------------------------------------------------ #
    # String handling                                                    #
    # ------------------------------------------------------------------ #

    @staticmethod
    def _convert_from_string(value):
        if isinstance(value, str):
            return np.frombuffer(value.encode("utf-8"), dtype=np.uint8).copy()
        return value  # already a byte tensor (e.g. from the pipeline)

    @staticmethod
    def _convert_to_string(value):
        if value is None:
            return None
        arr = np.asarray(value, dtype=np.uint8)
        # padded strings (from batching) are NUL-terminated
        data = arr.tobytes().split(b"\x00", 1)[0]
        return data.decode("utf-8")

    # ------------------------------------------------------------------ #
    # Assignment / access                                                #
    # ------------------------------------------------------------------ #

    def _apply_mapping_check_and_convert(self, name: Name, value):
        mapping = self._mappings.get(name)
        if mapping is not None and self._do_apply_mapping and isinstance(value, (str, type(None))):
            if value not in mapping:
                raise KeyError(
                    f"Value '{value}' not present in the mapping of field '{name}'"
                )
            value = mapping[value]
        t = self._types[name]
        np_dtype = numpy_dtype_for(t)
        if _is_traced(value):
            if self._do_check_type:
                actual = numpy_dtype_for_torch(value.dtype)
                expected = np.dtype(np_dtype)
                if actual != expected:
                    raise TypeError(
                        f"Field '{name}' expects dtype {expected}, got traced value of dtype {actual}"
                    )
            return value
        if self._do_convert and value is not None:
            value = np.asarray(value, dtype=np_dtype)
        return value

    def __setitem__(self, name: Name, value: Any):
        assert isinstance(name, (str, int)), f"'name' has unsupported type: `{type(name)}`"
        if name not in self._values:
            raise KeyError(f"No field with name '{name}'")
        if self._types[name] == SampleDataGroup:
            if not self[name].type_matches(value):
                raise KeyError(
                    f"Tried to set a data group field '{name}' "
                    f"(fields of type SampleDataGroup), but types do not match."
                )
            self._values[name] = value
        elif self._types[name] == DType.STRING and not _is_traced(value):
            self._values[name] = self._convert_from_string(value)
        else:
            self._values[name] = self._apply_mapping_check_and_convert(name, value)

    def set_item_in_path(self, path: Path, value: Any):
        """Assign at a nested path (parity: ``:403``)."""
        assert isinstance(path, (str, int, tuple, list)), "'path' has unsupported type"
        if isinstance(path, (tuple, list)):
            assert len(path) > 0, (
                "Only setting of children is supported. 'path' cannot be empty."
            )
            if path[0] not in self._values:
                raise KeyError(f"No field with name '{path[0]}'")
            if len(path) == 1:
                self[path[0]] = value
            else:
                self._values[path[0]].set_item_in_path(list(path[1:]), value)
        else:
            self[path] = value

    def __getitem__(self, name: Name) -> Any:
        assert isinstance(name, (str, int)), "'name' has unsupported type"
        if name not in self._values:
            raise KeyError(f"No field with name '{name}'")
        value = self._values[name]
        if self._types[name] == DType.STRING and not _is_traced(value):
            return self._convert_to_string(value)
        return value

    def _getitem_without_conversions(self, name: Name):
        return self._values[name]

    def get_item_in_path(self, path: Path) -> Any:
        """Get at a nested path (parity: ``:457``)."""
        assert isinstance(path, (str, int, tuple, list)), "'path' has unsupported type"
        if isinstance(path, (tuple, list)):
            if len(path) == 0:
                return self
            if path[0] not in self._values:
                raise KeyError(f"No field with name '{path[0]}'")
            if len(path) == 1:
                return self[path[0]]
            return self._values[path[0]].get_item_in_path(list(path[1:]))
        return self[path]

    def get_parent_of_path(self, path: Path) -> "SampleDataGroup":
        """The group containing the item at ``path`` (parity: ``:499``)."""
        if isinstance(path, (str, int)) or len(path) == 1:
            return self
        return self.get_item_in_path(list(path[:-1]))

    def get_type_of_item_in_path(self, path: Path):
        """Declared type at ``path`` (parity: ``:530``)."""
        parent = self.get_parent_of_path(path)
        last = path if isinstance(path, (str, int)) else path[-1]
        return parent.get_type_of_field(last)

    @staticmethod
    def path_is_single_name(path: Path) -> bool:
        return isinstance(path, (str, int)) or len(path) == 1

    def path_exists(self, path: Path) -> bool:
        """Whether ``path`` resolves (parity: ``:575``)."""
        try:
            self.get_item_in_path(path)
            return True
        except KeyError:
            return False

    def path_exists_and_is_data_group_field(self, path: Path) -> bool:
        if not self.path_exists(path):
            return False
        return self.get_type_of_item_in_path(path) == SampleDataGroup

    def get_type_of_field(self, name: Name):
        """Declared type of a direct child (DType or SampleDataGroup)."""
        if name not in self._types:
            raise KeyError(f"No field with name '{name}'")
        return self._types[name]

    # ------------------------------------------------------------------ #
    # Introspection                                                      #
    # ------------------------------------------------------------------ #

    def __len__(self) -> int:
        return len(self._value_order)

    def has_child(self, name: Name) -> bool:
        return name in self._values

    def is_array(self, field: Optional[Name] = None) -> bool:
        """True if field names are exactly ``0..len-1`` in order (parity: ``:667``)."""
        if field is not None:
            return self[field].is_array()
        return all(self._value_order[i] == i for i in range(len(self)))

    def is_data_field(self, name: Name) -> bool:
        return self._types.get(name) != SampleDataGroup and name in self._types

    def is_data_group_field(self, name: Name) -> bool:
        return self._types.get(name) == SampleDataGroup

    def is_data_field_array(self, field: Optional[Name] = None) -> bool:
        if field is not None:
            if not self.is_data_group_field(field):
                return False
            return self[field].is_data_field_array()
        return self.is_array() and all(self.is_data_field(i) for i in range(len(self)))

    def is_data_group_field_array(self, field: Optional[Name] = None) -> bool:
        if field is not None:
            if not self.is_data_group_field(field):
                return False
            return self[field].is_data_group_field_array()
        return self.is_array() and all(self.is_data_group_field(i) for i in range(len(self)))

    @property
    def contained_top_level_field_names(self) -> Tuple[Name, ...]:
        return self._value_order

    @property
    def field_top_level_types(self) -> Tuple[Any, ...]:
        return self._types_order

    @staticmethod
    def _flat_name(name: Name) -> str:
        return f"[{name}]" if isinstance(name, int) else str(name)

    def _get_contained_field_names_flat(self, prefix: str) -> List[str]:
        res = []
        for name, t in zip(self._value_order, self._types_order):
            flat = prefix + self._flat_name(name)
            if t == SampleDataGroup:
                child = self._values[name]
                if child is not None:
                    res += child._get_contained_field_names_flat(flat + ".")
            else:
                res.append(flat)
        return res

    @property
    def field_names_flat(self) -> Tuple[str, ...]:
        """Dotted names of all leaf data fields, depth-first; numeric names
        appear as ``[i]`` (parity: ``:761``)."""
        return tuple(self._get_contained_field_names_flat(""))

    @property
    def field_types_flat(self) -> Tuple[DType, ...]:
        """Types of all leaf data fields; strings report as UINT8, matching
        their in-pipeline representation (parity: ``:786``)."""
        res = []
        for name, t in zip(self._value_order, self._types_order):
            if t == SampleDataGroup:
                child = self._values[name]
                if child is not None:
                    res += list(child.field_types_flat)
            else:
                res.append(DType.UINT8 if t == DType.STRING else t)
        return tuple(res)

    @property
    def numpy_types_flat(self) -> Tuple[Any, ...]:
        """numpy dtypes of all leaf data fields (TPU-native convenience)."""
        return tuple(numpy_dtype_for(t) for t in self.field_types_flat)

    # ------------------------------------------------------------------ #
    # Flatten / unflatten                                                #
    # ------------------------------------------------------------------ #

    def get_data(self, as_list_type: bool = False) -> Union[tuple, list]:
        """Flat sequence of all leaf values, depth-first (parity: ``:809``).
        String fields contribute their raw uint8 tensors."""
        res: List[Any] = []
        for t, name in zip(self._types_order, self._value_order):
            if t == SampleDataGroup:
                res += self._values[name].get_data(True)
            else:
                res.append(self._getitem_without_conversions(name))
        return res if as_list_type else tuple(res)

    def _set_data_and_get_num_used(self, data: Sequence) -> int:
        used = 0
        for t, name in zip(self._types_order, self._value_order):
            if t == SampleDataGroup:
                used += self._values[name]._set_data_and_get_num_used(data[used:])
            else:
                self._values[name] = data[used]
                used += 1
        return used

    def set_data(self, data: Sequence):
        """Fill all leaf fields from a flat sequence; no conversions or
        mappings applied (parity: ``:855``)."""
        used = self._set_data_and_get_num_used(data)
        assert used == len(data), (
            f"Flat data has {len(data)} elements but the format holds {used}"
        )

    def set_data_from_iterator_output(self, data: List[Dict[str, Any]], index: int):
        """Fill from a name-keyed iterator output batch (parity:
        ``set_data_from_dali_generic_iterator_output``, ``:875``)."""
        names = self.field_names_flat
        self.set_data([data[index][name] for name in names])

    # Alias for call sites written against the reference name.
    set_data_from_dali_generic_iterator_output = set_data_from_iterator_output

    def get_like_self_filled_from_iterator_output(
        self, data: List[Dict[str, Any]], index: int
    ) -> "SampleDataGroup":
        """Blueprint copy filled from a name-keyed iterator batch (parity:
        reference ``get_like_self_filled_from_iterator_output``)."""
        res = self.get_empty_like_self()
        res.set_data_from_iterator_output(data, index)
        return res

    # ------------------------------------------------------------------ #
    # Format editing                                                     #
    # ------------------------------------------------------------------ #

    def _append_field(self, name: Name, t: Any):
        assert isinstance(name, (str, int)), f"'name' has unsupported type: {type(name)}"
        assert name not in self._values, f"Field '{name}' already exists"
        self._value_order = self._value_order + (name,)
        self._types_order = self._types_order + (t,)
        self._types[name] = t
        self._values[name] = None

    def add_data_field(self, name: Name, type: DType, mapping: Optional[dict] = None):
        """Add a leaf data field (parity: ``:914``). ``mapping`` optionally
        maps assigned strings (or None) to numeric values."""
        assert isinstance(type, DType), f"'type' must be a DType, got {type!r}"
        self._append_field(name, type)
        if mapping is not None:
            self._mappings[name] = dict(mapping)

    def add_data_group_field(self, name: Name, blueprint_sample_data_group: "SampleDataGroup"):
        """Add a child group, initialized as an empty blueprint copy of the
        given group (parity: ``:979``)."""
        assert isinstance(blueprint_sample_data_group, SampleDataGroup)
        self._append_field(name, SampleDataGroup)
        self._values[name] = blueprint_sample_data_group.get_empty_like_self()

    def add_data_field_array(
        self, name: str, type: DType, num_fields: int, mapping: Optional[dict] = None
    ):
        """Add a group that is an array of ``num_fields`` data fields
        (parity: ``:1004``)."""
        self.add_data_group_field(name, self.create_data_field_array(type, num_fields, mapping))

    def add_data_group_field_array(
        self, name: str, blueprint_sample_data_group: "SampleDataGroup", num_fields: int
    ):
        """Add a group that is an array of group blueprints (parity: ``:1036``)."""
        self.add_data_group_field(
            name, self.create_data_group_field_array(blueprint_sample_data_group, num_fields)
        )

    def remove_field(self, name: Name):
        """Remove a direct child (parity: ``:1063``)."""
        if name not in self._values:
            raise KeyError(f"No field with name '{name}'")
        idx = self._value_order.index(name)
        self._value_order = self._value_order[:idx] + self._value_order[idx + 1 :]
        self._types_order = self._types_order[:idx] + self._types_order[idx + 1 :]
        del self._values[name]
        del self._types[name]
        self._mappings.pop(name, None)

    def remove_all_occurrences(self, name_to_remove: Name):
        """Remove every field with the given name anywhere in the tree
        (parity: ``:1082``)."""
        for path in self.find_all_occurrences(name_to_remove):
            parent = self.get_parent_of_path(list(path))
            parent.remove_field(path[-1])

    def find_all_occurrences(self, name_to_find: Name) -> Tuple[Tuple[Name, ...], ...]:
        """Paths of every field (leaf or group) with the given name
        (parity: ``:1103``)."""
        res: List[Tuple[Name, ...]] = []

        def recurse(group: "SampleDataGroup", prefix: Tuple[Name, ...]):
            for name, t in zip(group._value_order, group._types_order):
                if name == name_to_find:
                    res.append(prefix + (name,))
                if t == SampleDataGroup and group._values[name] is not None:
                    recurse(group._values[name], prefix + (name,))

        recurse(self, ())
        return tuple(res)

    def get_num_occurrences(self, name_to_find: Name) -> int:
        return len(self.find_all_occurrences(name_to_find))

    def change_type_of_data_and_remove_data(
        self, name: Path, new_type: Any, mapping: Optional[dict] = None
    ):
        """Change a field's declared type, clearing its value
        (parity: ``:1145``). ``name`` may be a direct child name or a nested
        path; ``new_type`` is a DType or a SampleDataGroup blueprint (which
        makes the child a group field)."""
        if isinstance(name, (tuple, list)):
            parent = self.get_parent_of_path(list(name))
            parent.change_type_of_data_and_remove_data(name[-1], new_type, mapping)
            return
        if name not in self._values:
            raise KeyError(f"No field with name '{name}'")
        idx = self._value_order.index(name)
        if isinstance(new_type, SampleDataGroup):
            t = SampleDataGroup
            self._values[name] = new_type.get_empty_like_self()
        else:
            assert isinstance(new_type, DType)
            t = new_type
            self._values[name] = None
        self._types[name] = t
        self._types_order = self._types_order[:idx] + (t,) + self._types_order[idx + 1 :]
        self._mappings.pop(name, None)
        if mapping is not None:
            self._mappings[name] = dict(mapping)

    # ------------------------------------------------------------------ #
    # Batch utilities                                                    #
    # ------------------------------------------------------------------ #

    def ensure_uniform_size_in_batch(self, fill_value: Union[int, float]):
        """Right-pad every leaf value (a list of per-sample arrays) to a
        uniform per-batch shape (parity: ``:1257``). Host-side."""
        for name, t in zip(self._value_order, self._types_order):
            if t == SampleDataGroup:
                self._values[name].ensure_uniform_size_in_batch(fill_value)
                continue
            batch = self._values[name]
            if not isinstance(batch, list) or not batch:
                continue
            arrs = [np.atleast_1d(np.asarray(a)) for a in batch]
            ndim = max(a.ndim for a in arrs)
            arrs = [a.reshape(a.shape + (1,) * (ndim - a.ndim)) for a in arrs]
            target = tuple(max(a.shape[d] for a in arrs) for d in range(ndim))
            out = []
            for a in arrs:
                pad = [(0, target[d] - a.shape[d]) for d in range(ndim)]
                out.append(np.pad(a, pad, constant_values=fill_value))
            self._values[name] = out

    def ensure_uniform_size_in_batch_for_all_strings(self):
        """Pad per-sample string byte tensors with NUL to uniform length
        (parity: ``:1278``)."""
        for name, t in zip(self._value_order, self._types_order):
            if t == SampleDataGroup:
                self._values[name].ensure_uniform_size_in_batch_for_all_strings()
            elif t == DType.STRING:
                batch = self._values[name]
                if not isinstance(batch, list) or not batch:
                    continue
                arrs = [np.asarray(a, dtype=np.uint8).reshape(-1) for a in batch]
                max_len = max(a.shape[0] for a in arrs)
                self._values[name] = [
                    np.pad(a, (0, max_len - a.shape[0]), constant_values=0) for a in arrs
                ]

    def to_dictionary(self) -> dict:
        """Convert to nested plain dicts (strings decoded). Parity: ``:1321``."""
        res = {}
        for name, t in zip(self._value_order, self._types_order):
            if t == SampleDataGroup:
                res[name] = self._values[name].to_dictionary()
            else:
                res[name] = self[name]
        return res

    @staticmethod
    def get_numpy_type_for_dtype(dtype: DType):
        return numpy_dtype_for(dtype)

    # API-compat alias for call sites written against the reference name
    # (``get_numpy_type_for_dali_type``, sample_data_group.py:1339).
    get_numpy_type_for_dali_type = get_numpy_type_for_dtype

    def check_has_children(self, names: Sequence[Name], types: Optional[Sequence] = None):
        """Assert the given children (and optionally their types) exist
        (parity: ``:1353``)."""
        for i, name in enumerate(names):
            if not self.has_child(name):
                raise KeyError(f"Required field '{name}' is missing; format:\n{self}")
            if types is not None:
                actual = self._types[name]
                expected = types[i]
                if isinstance(expected, SampleDataGroup):
                    if actual != SampleDataGroup or not self._values[name].type_matches(expected):
                        raise TypeError(f"Field '{name}' has wrong format")
                elif actual != expected:
                    raise TypeError(
                        f"Field '{name}' has type {actual}, expected {expected}"
                    )

    # ------------------------------------------------------------------ #
    # Printing                                                           #
    # ------------------------------------------------------------------ #

    def _to_string_with_indent(self, indent: int, with_details: bool) -> str:
        pad = " " * indent
        lines = []
        for name, t in zip(self._value_order, self._types_order):
            if t == SampleDataGroup:
                child = self._values[name]
                body = child._to_string_with_indent(indent + 2, with_details) if child else ""
                lines.append(f"{pad}{name!r}: {{\n{body}{pad}}}")
            else:
                detail = ""
                if with_details:
                    has_value = self._values[name] is not None
                    has_map = name in self._mappings
                    detail = f"  # value={'set' if has_value else 'empty'}" + (
                        ", mapped" if has_map else ""
                    )
                lines.append(f"{pad}{name!r}: {t.name}{detail}")
        return "\n".join(lines) + ("\n" if lines else "")

    def get_string_no_details(self) -> str:
        return "{\n" + self._to_string_with_indent(2, False) + "}\n"

    def __str__(self) -> str:
        return "{\n" + self._to_string_with_indent(2, True) + "}\n"
