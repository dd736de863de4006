"""drivers of the H100 benchmark."""
