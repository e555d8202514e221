"""Field I/O: the ``.npz`` snapshots (``fields.py``), the Arnoldi
checkpoint/restart (``checkpoint.py``) and the Nek5000 ``#std`` field files
(``nek.py``), host numpy copies of the JAX package's ``io/``: each package
reads the other's files."""

from .checkpoint import ArnoldiCheckpoint
from .fields import FieldFile, field_path, load_field, save_field
from .nek import NekField, nek_to_layout, read_nek_field, write_nek_field

__all__ = ["save_field", "load_field", "field_path", "FieldFile", "ArnoldiCheckpoint",
           "read_nek_field", "write_nek_field", "nek_to_layout", "NekField"]
