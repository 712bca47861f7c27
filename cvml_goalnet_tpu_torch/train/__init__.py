"""Training of the port (counterparts of ``cvml_goalnet_tpu/train``): optimisers and the spotting head."""
