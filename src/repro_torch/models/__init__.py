"""Model stack: layers, GQA attention, the dense transformer, the family
dispatcher and parameter conversion."""
