"""The dense decoder LM of the port (gc-lm-110m and the Gemma family):
parameters in the reference's tree, forward pass and training loss."""
