"""The stabilized sLSTM recurrence over a whole sequence (CUDA kernel + plain version)."""
