"""Host runtime of the port: the native tokenizer and passage store, and the batching front end."""
