"""Migration compatibility: reference-format PyTorch checkpoints, both ways, and the reference's corpus."""

from cvml_goalnet_tpu_torch.compat.reference_runner import (
    REFERENCE_DIR,
    REFERENCE_VIDEO_IDS,
    build_reference_corpus,
    reference_available,
    synthetic_audio_features,
)
from cvml_goalnet_tpu_torch.compat.torch_import import (
    export_reference_state_dict,
    import_reference_arrays,
    import_reference_state_dict,
)

__all__ = ["REFERENCE_DIR", "REFERENCE_VIDEO_IDS", "build_reference_corpus", "export_reference_state_dict",
           "import_reference_arrays", "import_reference_state_dict", "reference_available",
           "synthetic_audio_features"]
