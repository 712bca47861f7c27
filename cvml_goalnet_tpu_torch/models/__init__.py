"""Eval-mode models of the port (counterparts of ``cvml_goalnet_tpu/models``)."""
