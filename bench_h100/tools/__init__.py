"""tools of the H100 benchmark."""
