"""The plain float32 reference the benchmark's check compares with: it imports
nothing of the program and takes nothing the program made."""
