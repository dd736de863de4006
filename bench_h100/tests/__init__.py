"""tests of the H100 benchmark."""
