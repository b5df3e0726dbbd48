"""Part of the perfbench benchmark."""
