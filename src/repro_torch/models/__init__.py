"""The dense decoder LM of the port (gc-lm-110m): parameters in the
reference's tree, forward pass and training loss."""
