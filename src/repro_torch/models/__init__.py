"""Model families of the port (the dense transformer in this slice)."""
