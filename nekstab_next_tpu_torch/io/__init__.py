"""Field I/O (the ``.npz`` snapshots of the JAX package's ``io/fields.py``).
The checkpoint/restart and the Nek5000 reader are not ported (ROADMAP item
16)."""

from .fields import FieldFile, field_path, load_field, save_field

__all__ = ["save_field", "load_field", "field_path", "FieldFile"]
