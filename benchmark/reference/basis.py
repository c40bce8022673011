"""1D Lagrange basis on Gauss-Lobatto-Legendre nodes and the two quadrature rules, on [0, 1]."""

from __future__ import annotations

import numpy as np

__all__ = ["gauss", "gauss_lobatto", "lagrange_tables", "tables"]


def gauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre points and weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def gauss_lobatto(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Lobatto-Legendre points (end points included) and
    weights on [0, 1]: the interior points are the roots of P'_{n-1}, the
    weights 2 / (n (n-1) P_{n-1}(x)^2) on [-1, 1]."""
    if n < 2:
        raise ValueError("Gauss-Lobatto needs two points or more")
    p = np.polynomial.legendre.Legendre.basis(n - 1)
    x = np.concatenate([[-1.0], np.sort(p.deriv().roots().real), [1.0]])
    w = 2.0 / (n * (n - 1) * p(x) ** 2)
    return (x + 1.0) / 2.0, w / 2.0


def lagrange_tables(nodes: np.ndarray, points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``S[q, i] = l_i(points[q])`` and ``D[q, i] = l_i'(points[q])`` for
    the Lagrange polynomials l_i on ``nodes``, by the product formulas."""
    n = len(nodes)
    S = np.ones((len(points), n))
    D = np.zeros((len(points), n))
    for i in range(n):
        others = [j for j in range(n) if j != i]
        for j in others:
            S[:, i] *= (points - nodes[j]) / (nodes[i] - nodes[j])
        for k in others:
            term = np.full(len(points), 1.0 / (nodes[i] - nodes[k]))
            for j in others:
                if j != k:
                    term *= (points - nodes[j]) / (nodes[i] - nodes[j])
            D[:, i] += term
    return S, D


def tables(degree: int, n_q: int, rule: str):
    """``(S, D, points, weights, collocated)`` of Q_degree on GLL nodes with an
    ``n_q``-point ``rule`` ("gauss" or "gauss_lobatto"). ``collocated``: the
    quadrature points are the nodes, so S is the identity."""
    nodes, _ = gauss_lobatto(degree + 1)
    if rule == "gauss":
        points, weights = gauss(n_q)
    elif rule == "gauss_lobatto":
        points, weights = gauss_lobatto(n_q)
    else:
        raise ValueError(f"unknown quadrature rule {rule!r}")
    S, D = lagrange_tables(nodes, points)
    collocated = rule == "gauss_lobatto" and n_q == degree + 1
    if collocated:
        S = np.eye(n_q)  # equal to the identity up to rounding
    return S, D, points, weights, collocated
