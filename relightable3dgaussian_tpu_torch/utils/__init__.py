"""Math helpers: spherical harmonics, quaternions, camera matrices."""
