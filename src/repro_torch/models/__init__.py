"""The LM zoo of the port: layers, attention (with the flash-attention kernel), blocks and model assembly for the dense family."""
