"""GQA online-softmax attention (CUDA kernel + plain version) and plain decode attention."""
