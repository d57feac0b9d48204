"""The four models as torch modules."""
