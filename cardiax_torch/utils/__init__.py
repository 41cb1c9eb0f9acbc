"""Host-side helpers: ``check_dict`` here, the DENSE geometry and ``.mat``
helpers in ``utils.dense`` (copies of ``cardiax/utils``)."""


def check_dict(d):
    """Pretty-print a dict of arrays/tensors by shape (reference
    modules/data/__init__.py:76-90 / modules/utils/__init__.py:3-17)."""
    import numpy as _np
    for key, value in d.items():
        if isinstance(value, _np.ndarray):
            desc = str(value) if value.size == 1 else str(value.shape)
        elif hasattr(value, "shape"):
            desc = str(tuple(value.shape))
        elif isinstance(value, dict):
            desc = str(list(value.keys()))
        elif isinstance(value, list):
            desc = f"list: ({len(value)})"
        else:
            desc = str(value)
        print("{:<60} {:<20}".format(key, desc))
