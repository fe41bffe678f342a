"""Model formats read by the port without their own libraries (tflite)."""
