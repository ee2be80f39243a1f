"""Model stack: layers, GQA attention, the Mamba-2 mixer, the dense and SSM
transformer, the family dispatcher and parameter conversion."""
