"""Per-frame and postprocessing ops of the port (counterparts of ``cvml_goalnet_tpu/ops``)."""
