"""Migration compatibility: reference-format PyTorch checkpoints, both ways."""

from cvml_goalnet_tpu_torch.compat.torch_import import (
    export_reference_state_dict,
    import_reference_arrays,
    import_reference_state_dict,
)

__all__ = ["export_reference_state_dict", "import_reference_arrays", "import_reference_state_dict"]
