"""Singleton base for the dev-time tooling (the port's own copy of
``accvlab_tpu/tools/singleton_base.py``)."""


class SingletonBase:
    """One instance per class; constructing again returns the existing one."""

    _instances = {}

    def __new__(cls, *args, **kwargs):
        if cls not in cls._instances:
            obj = super().__new__(cls)
            cls._instances[cls] = obj
            obj._singleton_initialized = False
        return cls._instances[cls]

    @classmethod
    def _reset_singleton(cls):
        """Drop the stored instance (test helper)."""
        cls._instances.pop(cls, None)
