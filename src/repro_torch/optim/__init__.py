"""AdamW, clipping and the LR schedule of the reference, in PyTorch."""
