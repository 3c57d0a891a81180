"""RAG apps over a person's own data, on leann_torch: mail (``email_rag``),
browser history (``browser_rag``), WeChat (``wechat_rag``, after
``wechat_exporter``), code (``code_rag``) and documents (``document_rag``).
Each runs as ``python -m leann_torch.apps.<name> --device cuda ...``; the
readers under ``email_data/`` and ``history_data/`` are the port's own
copies of the JAX package's."""
