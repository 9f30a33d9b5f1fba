"""Raw dataset conversion: ACDC, M&Ms and the Lib layout, and their synthetic phantoms."""
