/* Barnes-Hut octree gravity oracle: a faithful C re-implementation of the
 * reference's GJL module (gravOctree_Single.jl) used ONLY by tests and the
 * accuracy benchmark to establish the reference's force-error bar. It is
 * deliberately the reference algorithm, not the engine's design:
 *
 *   - octree built by splitting about cell centers, strict `> 0` on the
 *     relative coordinate (addNodes!, gravOctree_Single.jl:141-147),
 *     single-particle leaves (build_octree!, :213-227)
 *   - COM reverse sweep (setCOMs!, :183-211)
 *   - per-particle walk with the dual opening criterion
 *       s^2/d^2 < theta^2  &&  h_i^2 / mindist2(point, cell) < 0.25
 *     (compute_g, :239-278, criterion :265), monopole Newtonian for
 *     accepted nodes, softened kernels with h_ij = (h_i+h_j)/2 at leaves
 *     (Kernels, :5-29), own leaf removed (gravity_acc, :280-304)
 *   - PHI self-correction -(7/5) m / h_i (:303)
 *
 * Also exports an exact O(N^2) softened direct sum (the theta -> 0 limit)
 * so both the oracle's and the engine's force errors are measured in
 * f64 against the same ground truth.
 */

#include <math.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    double half;        /* cell half-edge ("Length" in the reference)   */
    double cx, cy, cz;  /* center */
    double mass;
    double comx, comy, comz;
    long first;         /* particle index for leaves, else -1 */
    long children[8];   /* node indices, -1 = absent */
    int n_children;
    int count;
} Node;

typedef struct {
    Node *nodes;
    long n_nodes, cap;
    const double *pos; /* (n,3) */
    double m;
} Tree;

static long new_node(Tree *t, double half, double cx, double cy, double cz) {
    if (t->n_nodes == t->cap) {
        t->cap *= 2;
        t->nodes = (Node *)realloc(t->nodes, t->cap * sizeof(Node));
    }
    Node *nd = &t->nodes[t->n_nodes];
    memset(nd, 0, sizeof(Node));
    nd->half = half;
    nd->cx = cx; nd->cy = cy; nd->cz = cz;
    nd->first = -1;
    for (int k = 0; k < 8; k++) nd->children[k] = -1;
    return t->n_nodes++;
}

/* recursive insert replicating the BFS splitter's particle routing:
 * child index from strict (coord - center) > 0 per axis */
static void insert(Tree *t, long node, long p, long depth) {
    Node *nd = &t->nodes[node];
    nd->count++;
    if (nd->count == 1 && depth < 512) {
        nd->first = p;
        return;
    }
    /* split: move resident particle down (if any), then insert p */
    long carry[2];
    int n_carry = 0;
    if (nd->first >= 0) { carry[n_carry++] = nd->first; nd->first = -1; }
    carry[n_carry++] = p;
    for (int c = 0; c < n_carry; c++) {
        long q = carry[c];
        const double *xp = t->pos + 3 * q;
        Node *ndc = &t->nodes[node]; /* realloc safety */
        int ox = xp[0] - ndc->cx > 0.0;
        int oy = xp[1] - ndc->cy > 0.0;
        int oz = xp[2] - ndc->cz > 0.0;
        int ci = 4 * oz + 2 * oy + ox;
        long child = t->nodes[node].children[ci];
        if (child < 0) {
            double h2 = t->nodes[node].half / 2.0;
            double ccx = t->nodes[node].cx + (ox ? h2 : -h2);
            double ccy = t->nodes[node].cy + (oy ? h2 : -h2);
            double ccz = t->nodes[node].cz + (oz ? h2 : -h2);
            child = new_node(t, h2, ccx, ccy, ccz);
            t->nodes[node].children[ci] = child;
            t->nodes[node].n_children++;
        }
        insert(t, child, q, depth + 1);
    }
}

static void set_coms(Tree *t, long node) {
    Node *nd = &t->nodes[node];
    if (nd->count == 1) {
        const double *xp = t->pos + 3 * nd->first;
        nd->mass = t->m;
        nd->comx = xp[0]; nd->comy = xp[1]; nd->comz = xp[2];
        return;
    }
    double mass = 0, wx = 0, wy = 0, wz = 0;
    for (int k = 0; k < 8; k++) {
        long c = nd->children[k];
        if (c < 0) continue;
        set_coms(t, c);
        Node *cn = &t->nodes[c];
        mass += cn->mass;
        wx += cn->mass * cn->comx;
        wy += cn->mass * cn->comy;
        wz += cn->mass * cn->comz;
    }
    nd = &t->nodes[node];
    nd->mass = mass;
    nd->comx = wx / mass; nd->comy = wy / mass; nd->comz = wz / mass;
}

/* softened kernels, gravOctree_Single.jl:5-29 */
static void kernels(double x, double y, double z, double r, double h,
                    double *gphi_o, double *phi_o) {
    double q = r / h;
    double gphi, phi;
    if (q <= 1.0) {
        gphi = (1.0 / (h * h)) *
               (4.0 / 3.0 / h - 1.2 * (r * r) / (h * h * h) +
                0.5 * (r * r * r) / (h * h * h * h));
        phi = (1.0 / h) * (2.0 / 3.0 * q * q - 0.3 * pow(q, 4) +
                           0.1 * pow(q, 5) - 1.4);
    } else if (q <= 2.0) {
        gphi = ((1.0 / (h * h)) *
                (8.0 / 3.0 * q - 3.0 * q * q + 1.2 * pow(q, 3) -
                 pow(q, 4) / 6.0 - 1.0 / 15.0 / (q * q))) / r;
        phi = (1.0 / h) * (4.0 / 3.0 * q * q - pow(q, 3) + 0.3 * pow(q, 4) -
                           pow(q, 5) / 30.0 - 1.6 + 1.0 / 15.0 / q);
    } else {
        gphi = 1.0 / (r * r * r);
        phi = -1.0 / r;
    }
    *gphi_o = gphi;
    *phi_o = phi;
}

static double min_dist2_point_cell(const double *p, const Node *nd) {
    double lox = nd->cx - nd->half, hix = nd->cx + nd->half;
    double loy = nd->cy - nd->half, hiy = nd->cy + nd->half;
    double loz = nd->cz - nd->half, hiz = nd->cz + nd->half;
    double dx = fmax(fmax(lox - p[0], 0.0), p[0] - hix);
    double dy = fmax(fmax(loy - p[1], 0.0), p[1] - hiy);
    double dz = fmax(fmax(loz - p[2], 0.0), p[2] - hiz);
    return dx * dx + dy * dy + dz * dz;
}

/* walk for particle i; own leaf excluded via skip_particle */
static void walk(const Tree *t, long node, long i, const double *h,
                 double theta_sq, double *g, double *phi) {
    const Node *nd = &t->nodes[node];
    if (nd->count == 1) {
        long j = nd->first;
        if (j == i) return; /* the reference removes the own leaf */
        const double *xi = t->pos + 3 * i;
        double dx = xi[0] - nd->comx, dy = xi[1] - nd->comy,
               dz = xi[2] - nd->comz;
        double d = sqrt(dx * dx + dy * dy + dz * dz);
        double h_ij = 0.5 * (h[i] + h[j]);
        double gphi, pot;
        kernels(dx, dy, dz, d, h_ij, &gphi, &pot);
        g[0] += nd->mass * gphi * dx;
        g[1] += nd->mass * gphi * dy;
        g[2] += nd->mass * gphi * dz;
        *phi += nd->mass * pot;
        return;
    }
    const double *xi = t->pos + 3 * i;
    double dx = xi[0] - nd->comx, dy = xi[1] - nd->comy, dz = xi[2] - nd->comz;
    double d_sq = dx * dx + dy * dy + dz * dz;
    double s = nd->half * 2.0; /* full edge, gravOctree_Single.jl:258 */
    if ((s * s / d_sq < theta_sq) &&
        (h[i] * h[i] / min_dist2_point_cell(xi, nd) < 0.25)) {
        double d = sqrt(d_sq);
        double f = nd->mass / (d * d * d);
        g[0] += f * dx;
        g[1] += f * dy;
        g[2] += f * dz;
        *phi += -nd->mass / d;
        return;
    }
    for (int k = 0; k < 8; k++)
        if (nd->children[k] >= 0)
            walk(t, nd->children[k], i, h, theta_sq, g, phi);
}

/* g (n,3), phi (n): per unit G, including particle mass m, with the
 * -(7/5) m / h self term on phi — same contract as GJL.gravity */
void bh_gravity(const double *pos, const double *h, double m, long n,
                double l_domain, double theta, double *g, double *phi) {
    Tree t;
    t.cap = 2 * n + 64;
    t.nodes = (Node *)malloc(t.cap * sizeof(Node));
    t.n_nodes = 0;
    t.pos = pos;
    t.m = m;
    long root = new_node(&t, l_domain, 0.0, 0.0, 0.0);
    for (long p = 0; p < n; p++) insert(&t, root, p, 0);
    set_coms(&t, root);
    double theta_sq = theta * theta;
    for (long i = 0; i < n; i++) {
        double gi[3] = {0, 0, 0}, phii = 0;
        walk(&t, root, i, h, theta_sq, &gi[0], &phii);
        g[3 * i + 0] = gi[0];
        g[3 * i + 1] = gi[1];
        g[3 * i + 2] = gi[2];
        phi[i] = phii - m * 1.4 / h[i];
    }
    free(t.nodes);
}

/* exact softened direct sum (theta -> 0 ground truth), same contract */
void exact_gravity(const double *pos, const double *h, double m, long n,
                   double *g, double *phi) {
    for (long i = 0; i < n; i++) {
        double gx = 0, gy = 0, gz = 0, pp = 0;
        const double *xi = pos + 3 * i;
        for (long j = 0; j < n; j++) {
            if (j == i) continue;
            const double *xj = pos + 3 * j;
            double dx = xi[0] - xj[0], dy = xi[1] - xj[1], dz = xi[2] - xj[2];
            double r = sqrt(dx * dx + dy * dy + dz * dz);
            double h_ij = 0.5 * (h[i] + h[j]);
            double gphi, pot;
            kernels(dx, dy, dz, r, h_ij, &gphi, &pot);
            gx += gphi * dx;
            gy += gphi * dy;
            gz += gphi * dz;
            pp += pot;
        }
        g[3 * i + 0] = m * gx;
        g[3 * i + 1] = m * gy;
        g[3 * i + 2] = m * gz;
        phi[i] = m * pp - m * 1.4 / h[i];
    }
}
