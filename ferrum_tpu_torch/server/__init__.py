"""The OpenAI-compatible server on the standard library (http.py)."""
