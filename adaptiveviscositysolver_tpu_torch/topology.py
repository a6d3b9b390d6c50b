"""Staggered-grid topology index maps (port of ``topology.py``).

The explicit maps between MAC-grid elements (cells, faces, edges, nodes)
and across levels, mirroring the reference's free functions
(reference Source/HDK_Utilities.h:46-217) with the JAX package's
conventions: integer index tensors of shape (..., 3); face d=0 is the
backward face; edge/node codes offset the transverse axes bit by bit.
"""

from __future__ import annotations

import torch


def _unit(axis, like):
    u = torch.zeros(3, dtype=like.dtype, device=like.device)
    u[axis] = 1
    return u


def cell_to_cell(cell, axis, direction):
    return cell + (1 if direction == 1 else -1) * _unit(axis, cell)


def cell_to_face(cell, axis, direction):
    return cell + direction * _unit(axis, cell)


def face_to_cell(face, axis, direction):
    return face - (1 - direction) * _unit(axis, face)


def cell_to_edge(cell, edge_axis, edge_index):
    t1, t2 = (edge_axis + 1) % 3, (edge_axis + 2) % 3
    return (cell + (edge_index & 1) * _unit(t1, cell)
            + ((edge_index >> 1) & 1) * _unit(t2, cell))


def edge_to_cell(edge, edge_axis, cell_index):
    t1, t2 = (edge_axis + 1) % 3, (edge_axis + 2) % 3
    return (edge - (1 - (cell_index & 1)) * _unit(t1, edge)
            - (1 - ((cell_index >> 1) & 1)) * _unit(t2, edge))


def cell_to_node(cell, node_index):
    off = torch.tensor([(node_index >> a) & 1 for a in range(3)],
                       dtype=cell.dtype, device=cell.device)
    return cell + off


def node_to_cell(node, cell_index):
    off = torch.tensor([1 - ((cell_index >> a) & 1) for a in range(3)],
                       dtype=node.dtype, device=node.device)
    return node - off


def face_to_edge(face, face_axis, edge_axis, direction):
    return face + direction * _unit(3 - face_axis - edge_axis, face)


def edge_to_face(edge, edge_axis, face_axis, direction):
    return edge - (1 - direction) * _unit(3 - face_axis - edge_axis, edge)


def face_to_node(face, face_axis, node_index):
    t1, t2 = (face_axis + 1) % 3, (face_axis + 2) % 3
    return (face + (node_index & 1) * _unit(t1, face)
            + ((node_index >> 1) & 1) * _unit(t2, face))


def node_to_face(node, face_axis, face_index):
    t1, t2 = (face_axis + 1) % 3, (face_axis + 2) % 3
    return (node - (1 - (face_index & 1)) * _unit(t1, node)
            - (1 - ((face_index >> 1) & 1)) * _unit(t2, node))


# --- inter-level maps (HDK_OctreeGrid.h:53-142) ---


def parent(index):
    return index >> 1


def child_cell(cell, child_index):
    off = torch.tensor([(child_index >> a) & 1 for a in range(3)],
                       dtype=cell.dtype, device=cell.device)
    return 2 * cell + off


def child_face(face, axis, child_index):
    t1, t2 = (axis + 1) % 3, (axis + 2) % 3
    return (2 * face + (child_index & 1) * _unit(t1, face)
            + ((child_index >> 1) & 1) * _unit(t2, face))


def child_edge(edge, edge_axis, child_index):
    return 2 * edge + child_index * _unit(edge_axis, edge)


def child_node(node):
    return 2 * node


def child_edge_in_face(face, face_axis, edge_axis, child_index):
    """Edges inset in a coarse face one level down (HDK_OctreeGrid.h:126-142)."""
    return (2 * face + child_index * _unit(edge_axis, face)
            + _unit(3 - face_axis - edge_axis, face))
