"""Device arithmetic of the port: limbs, NTT, G1, MSM, SRS, polynomials."""
