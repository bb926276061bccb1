"""Host utilities: python-int polynomial arithmetic (`py_poly`)."""
