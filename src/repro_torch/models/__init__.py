"""The LM zoo of the port: layers, attention (with the flash-attention kernel), blocks, the xLSTM blocks (with the sLSTM kernel) and model assembly for the dense and xlstm families."""
