"""Peak decoding."""
