"""Host-side utilities: the native point ops, metrics logging and summary
plots."""
