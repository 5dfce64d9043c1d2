"""The drivers of a cell's window, one module per traffic kind."""
