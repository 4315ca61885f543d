"""Core algorithms of the port: late interaction, the streaming scan,
quantization, pruning and the flat index."""
