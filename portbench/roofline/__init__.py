"""Bytes and operations of each kernel function, one file each."""
