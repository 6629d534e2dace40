"""The plain references the benchmark holds the port's outputs to; nothing
here imports the port."""
