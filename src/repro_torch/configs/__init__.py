"""Architecture configs of the port: the LM architectures as data and the
paper's colpali-hpc system."""
