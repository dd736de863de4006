"""metrics of the H100 benchmark."""
