/* Native frame-export writer: the IO role of the reference's Brender
 * exporter (c++/PCG/online/Brender/cpp/BrenderManager.{h,cpp},
 * Brenderable.h:15-31 — per-frame OBJ dumps for Blender import).
 *
 * Exporting a long trajectory means formatting millions of vertex lines;
 * that float-formatting + fwrite loop is the hot host-side path, so it
 * lives in C. The forward kinematics that gives the [T, nb, 4, 4] world
 * transforms runs in export.py. A copy of the JAX package's csrc/export.c;
 * kernel_build's host build (g++, which compiles it as C++: hence the
 * extern "C") makes it at first use into _build/, loaded with ctypes.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* Unit-cube corner offsets, matching export.py _CUBE_VERTS. */
static const double CUBE[8][3] = {
    {-0.5, -0.5, -0.5}, {-0.5, -0.5, 0.5}, {-0.5, 0.5, -0.5}, {-0.5, 0.5, 0.5},
    {0.5, -0.5, -0.5},  {0.5, -0.5, 0.5},  {0.5, 0.5, -0.5},  {0.5, 0.5, 0.5},
};
static const int FACES[12][3] = {
    {0, 1, 3}, {0, 3, 2}, {4, 6, 7}, {4, 7, 5},
    {0, 4, 5}, {0, 5, 1}, {2, 3, 7}, {2, 7, 6},
    {0, 2, 6}, {0, 6, 4}, {1, 5, 7}, {1, 7, 3},
};

#ifdef __cplusplus
extern "C" {
#endif

/* Write frames [0, T) with the given stride as dir/frame_%05d.obj.
 * E: row-major [T, nb, 4, 4] world transforms; sides: [nb, 3] cuboid
 * dimensions. Returns the number of frames written, or -1 on IO error. */
int write_frames_obj(const char *dir, const double *E, const double *sides,
                     long T, long nb, long stride)
{
    char path[4096];
    long k, b, n = 0;
    int i, j;
    if (stride < 1) stride = 1;
    for (k = 0; k < T; k += stride) {
        snprintf(path, sizeof(path), "%s/frame_%05ld.obj", dir, n);
        FILE *fh = fopen(path, "w");
        if (!fh) return -1;
        long voff = 1;
        for (b = 0; b < nb; b++) {
            const double *Eb = E + (k * nb + b) * 16;
            const double *s = sides + b * 3;
            for (i = 0; i < 8; i++) {
                double v[3];
                for (j = 0; j < 3; j++)
                    v[j] = Eb[j * 4 + 0] * CUBE[i][0] * s[0] +
                           Eb[j * 4 + 1] * CUBE[i][1] * s[1] +
                           Eb[j * 4 + 2] * CUBE[i][2] * s[2] + Eb[j * 4 + 3];
                fprintf(fh, "v %.6f %.6f %.6f\n", v[0], v[1], v[2]);
            }
            for (i = 0; i < 12; i++)
                fprintf(fh, "f %ld %ld %ld\n", FACES[i][0] + voff,
                        FACES[i][1] + voff, FACES[i][2] + voff);
            voff += 8;
        }
        if (fclose(fh) != 0) return -1;
        n++;
    }
    return (int)n;
}

#ifdef __cplusplus
}
#endif
