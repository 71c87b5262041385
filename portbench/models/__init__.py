"""One module per model kind a configuration file names, with its plain reference and its work counts."""
