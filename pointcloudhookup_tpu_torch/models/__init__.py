"""Tower schema and the extraction pipeline."""
