"""AdamW as plain functions on trees of tensors."""
