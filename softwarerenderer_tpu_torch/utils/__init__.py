"""Math helpers in the reference's row-vector conventions."""
