"""Serving workload of the port: the paged engine, its HTTP front and the
byte tokenizer."""
