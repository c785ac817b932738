from .convert import convert_merged, convert_unmerged  # noqa: F401
from .export import export_reference_merged  # noqa: F401
from .serialize import (  # noqa: F401
    flatten_tree,
    load_checkpoint,
    save_checkpoint,
    unflatten_tree,
)
