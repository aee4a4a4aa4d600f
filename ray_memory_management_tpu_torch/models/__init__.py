"""Models: the GPT TransformerLM and parameter conversion."""
