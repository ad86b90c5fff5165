from .padding import pad_to, pad_rows
